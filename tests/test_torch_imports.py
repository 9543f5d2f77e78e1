"""The port stands alone: importing ``repro_torch`` (every module of it),
``chip_smoke.py`` and the torch examples (``examples/torch_*.py``) brings in
neither ``jax`` nor the ``repro`` package; and nothing falls back to the CPU
on its own."""
import pathlib
import pkgutil
import subprocess
import sys

import pytest

import repro_torch
from repro_torch.fed import backends, engine, simulator

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _module_names():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    names = _module_names()
    assert "repro_torch.kernels.gossip_mix.kernel" in names and len(names) >= 25
    assert {"repro_torch.kernels.kl_simplex.kernel", "repro_torch.kernels.kl_simplex.ops",
            "repro_torch.kernels.kl_simplex.ref", "repro_torch.core.baselines",
            "repro_torch.fed.metrics", "repro_torch.fed.algorithms.sp",
            "repro_torch.fed.algorithms.dfl", "repro_torch.fed.algorithms.d_sgd",
            "repro_torch.fed.algorithms.d_fedavg", "repro_torch.precision",
            "repro_torch.kernels.flash_attention.kernel", "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.flash_attention.ref", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.transformer",
            "repro_torch.configs.registry", "repro_torch.configs.qwen3_1_7b",
            "repro_torch.launch.serve", "repro_torch.core.vehicle_axis",
            "repro_torch.launch.sweep", "repro_torch.launch.campaign",
            "repro_torch.launch.results_store", "repro_torch.launch.report",
            "repro_torch.launch.mesh",
            "repro_torch.registries", "repro_torch.figures.common",
            "repro_torch.figures.run", "repro_torch.figures.fig2_cdf",
            "repro_torch.figures.fig3_correlation", "repro_torch.figures.fig6_7_cifar",
            "repro_torch.figures.fig8_mnist", "repro_torch.figures.fig9_epochs_to_target",
            "repro_torch.figures.fig10_consensus",
            "repro_torch.figures.fig_overlap", "repro_torch.roofline.hw",
            "repro_torch.roofline.flop_cost", "repro_torch.roofline.bench_schema",
            "repro_torch.roofline.scenario_cost", "repro_torch.checkpoint.checkpoint",
            "repro_torch.launch.train", "repro_torch.models.moe", "repro_torch.models.rwkv6",
            "repro_torch.models.ssm", "repro_torch.models.multimodal",
            "repro_torch.launch.steps", "repro_torch.launch.variants",
            "repro_torch.optim.schedules", "repro_torch.launch.shapes",
            "repro_torch.launch.sharding", "repro_torch.launch.dryrun",
            "repro_torch.roofline.analysis", "repro_torch.kernels.grouped_mm.kernel",
            "repro_torch.kernels.grouped_mm.ops",
            "repro_torch.kernels.grouped_mm.ref"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_chip_smoke_imports_neither_and_fails_without_a_gpu():
    source = (ROOT / "chip_smoke.py").read_text()
    import ast
    imported = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module.split(".")[0])
    assert not imported & {"jax", "jaxlib", "repro"}, imported
    assert "repro_torch" in imported
    # importing it as a module (no __main__) loads neither, and runs nothing
    code = ("import sys, importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
            "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PATH": ""})
    assert out.returncode == 0, out.stderr
    import torch
    if not torch.cuda.is_available():
        run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                             capture_output=True, text=True, cwd=ROOT, env={"PATH": ""})
        assert run.returncode != 0
        assert '"ok"' not in run.stdout


TORCH_EXAMPLES = ["torch_multiarch_dfl.py", "torch_quickstart.py", "torch_scenario_sweep.py",
                  "torch_serve_batched.py", "torch_vehicular_mnist_e2e.py"]


def test_torch_examples_import_neither_jax_nor_repro():
    import ast
    assert sorted(p.name for p in (ROOT / "examples").glob("torch_*.py")) == TORCH_EXAMPLES
    for name in TORCH_EXAMPLES:
        path = ROOT / "examples" / name
        imported = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                imported |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                imported.add(node.module.split(".")[0])
        assert not imported & {"jax", "jaxlib", "repro"} and "repro_torch" in imported, name
        # loaded as a module (no __main__): its imports bring in neither
        code = ("import sys, importlib.util\n"
                f"spec = importlib.util.spec_from_file_location('ex', {str(path)!r})\n"
                "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
                "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
                "assert not bad, bad\n")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             cwd=ROOT, env={"PATH": ""})
        assert out.returncode == 0, (name, out.stderr)


def test_importing_the_dry_run_starts_no_group_and_no_cuda():
    """The dry run's module brings up its fake group only when a pair runs,
    and never touches CUDA: importing it (and the launch modules it uses)
    leaves no process group and CUDA uninitialised."""
    code = ("import torch, torch.distributed as dist\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.sharding\n"
            "import repro_torch.launch.shapes, repro_torch.roofline.analysis\n"
            "assert not dist.is_initialized()\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_device_cuda_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = simulator.SimulationConfig(num_vehicles=4, epochs=1)
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.resolve_device(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulator.run_simulation(cfg)


def test_serve_cli_with_device_cuda_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])          # --device defaults to cuda
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b",
                          "--reduced", "--device", "cuda"], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert run.returncode != 0 and "no CUDA device" in run.stderr
    assert "generated ids" not in run.stdout


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_train_cli_with_device_cuda_without_a_card_raises_for_a_transformer(arch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", arch, "--reduced", "--steps", "1"])   # --device defaults to cuda
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                          "--reduced", "--steps", "1", "--device", "cuda"],
                         capture_output=True, text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert run.returncode != 0 and "no CUDA device" in run.stderr
    assert "loss=" not in run.stdout


def test_shard_map_backend_builds_a_context():
    """``backend="shard_map"`` is ported: it builds a context and, with no
    process group up, runs the global path."""
    from repro_torch.data.synthetic import synthetic_mnist
    cfg = simulator.SimulationConfig(num_vehicles=4, epochs=1, device="cpu",
                                     backend="shard_map", eval_samples=20)
    ctx = engine.build_context(cfg, dataset=synthetic_mnist(n_train=200, n_test=20))
    assert "shard_map" in backends.available_backends()
    assert backends.get_backend("shard_map").shard_for(cfg, ctx.total_nodes).is_sharded is False


@pytest.mark.parametrize("field,value", [
    ("algorithm", "nope"), ("backend", "nope"), ("overlap", "nope"),
    ("execution", "nope"), ("mixing_backend", "pallas"), ("contact_format", "csr"),
])
def test_unknown_values_raise_value_error(field, value):
    from repro_torch.data.synthetic import synthetic_mnist
    cfg = simulator.SimulationConfig(num_vehicles=4, epochs=1, device="cpu",
                                     **{field: value})
    with pytest.raises(ValueError):
        engine.build_context(cfg, dataset=synthetic_mnist(n_train=200, n_test=20))


def test_registries():
    from repro_torch.fed import algorithms
    assert algorithms.available_algorithms() == ["d_fedavg", "d_sgd", "dds", "dfl", "sp"]
    assert backends.available_backends() == ["shard_map", "vmap"]
    for name in algorithms.available_algorithms():
        assert algorithms.get_algorithm(name).name == name
