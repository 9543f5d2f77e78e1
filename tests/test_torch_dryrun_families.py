"""The port's dry run on a 4-rank ``fake`` group for two more families, one
reduced architecture each — MoE (granite-moe-1b-a400m, dense dispatch) and
RWKV-6 — at a train round (vehicle 2 x fsdp 1 x model 2), prefill and decode
(data 2 x model 2): every record has the reference's keys, no error, a shard
of the work and the collectives of its kind (``test_torch_dryrun.check_family``).
The dense architecture and the checks against an unsharded count are in
``test_torch_dryrun.py``; the hybrid and VLM families in
``test_torch_dryrun_hybrid_vlm.py`` (a file each keeps every file short).
"""
import pytest

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

from test_torch_dryrun import SHAPES, check_family, run_small

ARCHS = ["granite-moe-1b-a400m", "rwkv6-3b"]


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
