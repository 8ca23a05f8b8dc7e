"""The PyTorch port stands alone: no module of flexflow_tpu_torch (nor
chip_smoke.py) imports jax or flexflow_tpu, importing the package
leaves jax unloaded, a default-device build refuses to run without
CUDA, and the kernel build names nvcc when it cannot find it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "flexflow_tpu_torch"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    names = {f.name for f in files}
    assert {"flash_attention.py", "_build.py", "loss.py", "metrics.py",
            "optimizer.py", "dataloader.py", "shape.py", "bn_apply.py",
            "layout.py", "checkpoint.py", "moe.py", "moe_dispatch.py",
            "experts.py", "inception.py", "resnet.py", "dlrm.py",
            "candle_uno.py", "alexnet.py", "mlp.py", "recurrent.py",
            "nmt.py", "protowire.py", "datasets.py", "callbacks.py",
            "layers.py", "sequence.py", "text.py", "export.py",
            "unity.py", "mcmc.py", "evaluator.py", "rewrite.py",
            "substitution.py", "segments.py", "search.py", "simulator.py",
            "machine_model.py", "taskgraph.py", "calibrate.py",
            "parallel_op.py", "machine.py", "pipeline_plan.py",
            "pipeline.py", "comm.py", "expert_parallel.py",
            "strategy.py", "profiler.py", "logger.py", "hierarchy.py",
            "network.py", "capture.py", "zero.py", "taso.py",
            "taso_pb.py", "key.py", "store.py", "blobstore.py",
            "faults.py", "trace.py", "fidelity.py", "async_writer.py",
            "watchdog.py", "retry.py", "pb_to_json.py",
            "substitutions_to_dot.py", "telemetry_summary.py",
            "checkpoint_fsck.py", "strategy_store_import.py",
            "check_metric_docs.py", "speculative.py", "scheduler.py",
            "kv_pool.py", "server.py", "decoding.py"} <= names
    for sub in ("keras", "keras/preprocessing", "onnx_frontend", "sim",
                "parallel", "topology", "native", "pcg", "store",
                "resilience", "obs", "tools"):
        assert (PORT / sub / "__init__.py").is_file(), sub
    for sub in ("sim", "parallel", "topology", "pcg", "store",
                "resilience", "obs", "tools"):
        assert any(f.parent == PORT / sub and f.name != "__init__.py"
                   for f in files), sub
    offenders = [(str(f.relative_to(ROOT)), m) for f in files
                 for m in _imported_roots(f)
                 if m in ("jax", "jaxlib", "flexflow_tpu")]
    assert offenders == []


def test_import_leaves_jax_unloaded():
    code = ("import sys, flexflow_tpu_torch, flexflow_tpu_torch.serving, "
            "flexflow_tpu_torch.serving.speculative, "
            "flexflow_tpu_torch.decoding, flexflow_tpu_torch.convert, "
            "flexflow_tpu_torch.models, flexflow_tpu_torch.checkpoint, "
            "flexflow_tpu_torch.ops.moe, flexflow_tpu_torch.ops.experts, "
            "flexflow_tpu_torch.ops.kernels.flash_attention, "
            "flexflow_tpu_torch.ops.kernels.bn_apply, "
            "flexflow_tpu_torch.pcg.layout, "
            "flexflow_tpu_torch.torch_frontend, "
            "flexflow_tpu_torch.ops.recurrent, "
            "flexflow_tpu_torch.models.nmt, flexflow_tpu_torch.keras, "
            "flexflow_tpu_torch.keras.datasets, "
            "flexflow_tpu_torch.keras.preprocessing, "
            "flexflow_tpu_torch.onnx_frontend, "
            "flexflow_tpu_torch.onnx_frontend.protowire, "
            "flexflow_tpu_torch.onnx_frontend.export, "
            "flexflow_tpu_torch.pcg.unity, flexflow_tpu_torch.pcg.mcmc, "
            "flexflow_tpu_torch.pcg.search, flexflow_tpu_torch.pcg.rewrite, "
            "flexflow_tpu_torch.sim.simulator, "
            "flexflow_tpu_torch.sim.taskgraph, "
            "flexflow_tpu_torch.sim.calibrate, "
            "flexflow_tpu_torch.parallel.pipeline_plan, "
            "flexflow_tpu_torch.parallel.pipeline, "
            "flexflow_tpu_torch.parallel.expert_parallel, "
            "flexflow_tpu_torch.topology.comm, "
            "flexflow_tpu_torch.topology.hierarchy, "
            "flexflow_tpu_torch.sim.network, "
            "flexflow_tpu_torch.native, flexflow_tpu_torch.profiler, "
            "flexflow_tpu_torch.strategy, flexflow_tpu_torch.capture, "
            "flexflow_tpu_torch.parallel.zero, "
            "flexflow_tpu_torch.pcg.taso, flexflow_tpu_torch.store, "
            "flexflow_tpu_torch.resilience, "
            "flexflow_tpu_torch.tools.pb_to_json, "
            "flexflow_tpu_torch.tools.substitutions_to_dot, "
            "flexflow_tpu_torch.tools.telemetry_summary, "
            "flexflow_tpu_torch.tools.checkpoint_fsck, "
            "flexflow_tpu_torch.tools.strategy_store_import, "
            "flexflow_tpu_torch.tools.check_metric_docs; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'flexflow_tpu' or "
            "m.startswith('flexflow_tpu.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_default_device_build_raises_without_cuda(monkeypatch):
    from flexflow_tpu_torch import FFConfig, FFModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert FFConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        FFModel(FFConfig())
    FFModel(FFConfig(device="cpu"))  # the host on request


@pytest.mark.parametrize("kernel", ["paged_attention", "flash_attention",
                                    "bn_apply"])
def test_kernel_build_names_nvcc_when_missing(monkeypatch, tmp_path, kernel):
    """Every kernel module builds through the one helper, which names
    nvcc when it cannot find it."""
    import importlib

    from flexflow_tpu_torch.ops.kernels import _build

    mod = importlib.import_module(f"flexflow_tpu_torch.ops.kernels.{kernel}")
    assert mod.SOURCE.is_file() and mod.SOURCE.parent == _build.CSRC
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(mod.SOURCE)
    with pytest.raises(RuntimeError, match="nvcc"):
        mod.load_library()
    # the library name follows the source's content and the flags
    assert _build.library_path(mod.SOURCE).name.startswith(f"libff_{kernel}_")


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """The wrapper picks the plain version only for CPU tensors: a
    non-CPU tensor goes to the kernel's checks and launch (here the
    first check raises), never to the gather formulation."""
    from flexflow_tpu_torch.ops.kernels import paged_attention as pk

    calls = []
    monkeypatch.setattr(pk, "paged_attention_plain",
                        lambda *a: calls.append(a))
    q = torch.zeros(1, 1, 1, 64, device="meta")
    with pytest.raises(ValueError):
        pk.paged_attention(q, q, q, q, q, 0.125)
    assert calls == [] and pk.paged_attention.launches == 0


def test_config_flags_match_the_reference():
    from flexflow_tpu.config import FFConfig as JaxConfig

    from flexflow_tpu_torch import FFConfig

    argv = ["-b", "3", "--seed", "5", "--kv-page-size", "4",
            "--kv-pool-blocks", "33", "--serving-slots", "2",
            "--prefill-chunk", "0", "--no-prefix-cache", "-e", "4",
            "--lr", "0.5", "--wd", "0.25", "--flash-min-seq", "512"]
    mine, ref = FFConfig.from_args(argv), JaxConfig.from_args(argv)
    fields = ("batch_size", "seed", "kv_page_size", "kv_pool_blocks",
              "serving_slots", "prefill_chunk", "prefix_cache",
              "compute_dtype", "epochs", "learning_rate", "weight_decay",
              "flash_min_seq")
    for f in fields:
        assert getattr(mine, f) == getattr(ref, f), f
    long_names = ["--epochs", "7", "--learning-rate", "0.125",
                  "--weight-decay", "0.0", "--flash-min-seq", "0"]
    mine, ref = FFConfig.from_args(long_names), JaxConfig.from_args(long_names)
    for f in fields:
        assert getattr(mine, f) == getattr(ref, f), f
    defaults = FFConfig.from_args([]), JaxConfig.from_args([])
    for f in fields:
        assert getattr(defaults[0], f) == getattr(defaults[1], f), f
    assert FFConfig.from_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(ValueError, match="kv_page_size"):
        FFConfig(kv_page_size=0)
    with pytest.raises(ValueError, match="flash_min_seq"):
        FFConfig(flash_min_seq=-1)
    with pytest.raises(ValueError, match="device"):
        FFConfig(device="tpu")
    assert os.path.isfile(PORT / "csrc" / "paged_attention.cu")
    assert os.path.isfile(PORT / "csrc" / "flash_attention.cu")
    assert os.path.isfile(PORT / "csrc" / "bn_apply.cu")


def test_native_library_builds_into_the_ignored_build_dir(tmp_path,
                                                          monkeypatch):
    """The event loop's C++ builds with the C++ compiler into
    flexflow_tpu_torch/_build/, which .gitignore lists; nothing is built
    at import, and a failed compile raises."""
    from flexflow_tpu_torch import native

    assert native.BUILD_DIR == PORT / "_build"
    assert "flexflow_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()
    assert native.SOURCE == PORT / "native" / "taskgraph_sim.cc"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    out = native.build(os.environ.get("CXX", "g++"))
    assert out.parent == tmp_path / "b" and out.name.startswith("libffsim_")
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed"):
        native.build(os.environ.get("CXX", "g++"))
