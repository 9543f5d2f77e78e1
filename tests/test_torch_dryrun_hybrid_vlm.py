"""The port's dry run on a 4-rank ``fake`` group for the hybrid SSM
(hymba-1.5b) and a VLM prefix (internvl2-26b), reduced, at a train round,
prefill and decode, as ``test_torch_dryrun_families.py`` runs MoE and RWKV-6.
"""
import pytest

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

from test_torch_dryrun import SHAPES, check_family, run_small

ARCHS = ["hymba-1.5b", "internvl2-26b"]


@pytest.fixture(scope="module")
def records():
    """Every (arch, kind) record, on a group torn down before any test runs."""
    dryrun._fake_group(4)
    try:
        return {(arch, kind): run_small(arch, kind) for arch in ARCHS for kind in SHAPES}
    finally:
        mesh_lib.shutdown()


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_family_runs_sharded(records, arch, kind):
    check_family(records[(arch, kind)], arch, kind)
