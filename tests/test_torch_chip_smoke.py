"""chip_smoke.py's bookkeeping that runs without a card: the flash
kernels' bounds on the route each kernel takes, the count of tensor
core instructions per kernel instance read from a SASS listing, the
paged-attention kernel's split grid and bytes bound, the phase list,
the ViT-B/16 op-count table, the profiles' kernel kinds and busy time
over two streams, the zoo phases' table, graphs, layout plan, MoE
routing record and tiny feeds, and the sequence and frontend phases'
NMT sizing, data and gradient check, the dense twin's cache bytes, the
generation check's exact equality, the Keras example table and its
data, the profiled kernel time's retake of a profile that lost
records, the store phase's catalog (both forms parse equal and
verify, its rules match BERT's graph), its kernel-cache check and its
launches in the kernels line, and the supervised phase and legs: their
place, fault plan, survivors, tolerances and launches in the kernels
line, the Cache op dropped from a graph, and the unchanged last line."""
import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

# BERT-base at batch 8, seq 2048: [96, 2048, 64]
SHAPE = (96, 2048, 2048, 64)


def test_flash_bounds_name_the_route_of_each_kernel():
    """float32: K1, K2 and K3 on the tensor cores in three TF32 passes
    (3 x flops at 495 TFLOP/s); the SIMT bound (flops at 67 TFLOP/s) is
    reported beside it."""
    b = chip_smoke.flash_bounds(*SHAPE)
    pairs = 96 * 2048 * 2048 * 64
    for kern, flops in (("K1", 4 * pairs), ("K2", 6 * pairs),
                        ("K3", 8 * pairs)):
        assert b[kern]["flops"] == flops
        assert b[kern]["simt_bound_ms"] == pytest.approx(flops / 67e9)
        assert b[kern]["tc_bound_ms"] == pytest.approx(3 * flops / 495e9)
    for kern, ms in (("K1", 0.625), ("K2", 0.937), ("K3", 1.249)):
        assert b[kern]["route"] == "tensor_cores"
        assert b[kern]["bound_ms"] == b[kern]["tc_bound_ms"]
        assert b[kern]["bound_ms"] == pytest.approx(ms, abs=5e-4)
        assert b[kern]["bound_by"] == "operations, 3xTF32 tensor cores"
    assert b["K1"]["simt_bound_ms"] == pytest.approx(1.538, abs=5e-4)


def test_flash_bounds_in_bfloat16():
    """bfloat16 products take one pass at 989 TFLOP/s and move half the
    bytes (LSE and delta stay float32)."""
    b32 = chip_smoke.flash_bounds(*SHAPE)
    b16 = chip_smoke.flash_bounds(*SHAPE, "bfloat16")
    for kern in ("K1", "K2", "K3"):
        assert b16[kern]["bound_ms"] == pytest.approx(
            b16[kern]["flops"] / 989e9)
        assert b16[kern]["bound_by"] == "operations, bfloat16 tensor cores"
        assert b16[kern]["bytes"] < b32[kern]["bytes"]
    assert b16["K1"]["bound_ms"] == pytest.approx(0.104, abs=5e-4)


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN51_GLOBAL__N__0015155a_18_flash_attention_cu_1859254719flash_bwd_dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iifi
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.1688.F32.TF32 R4, R10, R14, R4 ;
        /*0120*/                   LDSM.16.M88.4 R8, [R2] ;
\t\tFunction : _ZN51_GLOBAL__N__0015155a_18_flash_attention_cu_1859254720flash_bwd_dkv_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iifi
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
\t\tFunction : _ZN51_GLOBAL__N__0015155a_18_flash_attention_cu_1859254716flash_fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_Pfiifi
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0110*/                   FFMA R4, R8, R12, R4 ;
\t\tFunction : _ZN61_GLOBAL__N__paged_attention_kernelIfLi64EEEvPKfS1_S1_PKiS3_Pfiiiif
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
"""


def test_count_sass_per_kernel_instance():
    assert chip_smoke.count_sass(SASS) == {
        "K2 float32 d64": {"hmma": 2, "instructions": 3},
        "K3 bfloat16 d128": {"hmma": 1, "instructions": 1},
        "K1 float32 d64": {"hmma": 1, "instructions": 2}}


@pytest.mark.parametrize("m,c,itemsize,res,relu,ms", [
    (802816, 256, 2, True, True, 0.368),
    (802816, 256, 2, False, True, 0.245),
    (802816, 256, 2, False, False, 0.245),
    (200704, 512, 2, True, True, 0.184),
    (12544, 2048, 2, True, True, 0.046),
    (802816, 256, 4, True, True, 0.736),
])
def test_bn_apply_bound_is_its_bytes(m, c, itemsize, res, relu, ms):
    """P1 reads x (and res) and writes y once: bytes over 3.35 TB/s,
    far above its 2-4 float32 operations per element at 67 TFLOP/s."""
    bound, by = chip_smoke.bn_bound_ms(m, c, itemsize, res, relu)
    assert by == "bytes"
    assert chip_smoke.bn_bytes(m, c, itemsize, res) == \
        (3 if res else 2) * m * c * itemsize + 2 * c * itemsize
    assert bound == pytest.approx(ms, abs=5e-4)


@pytest.mark.parametrize("width,split,splits", [(64, 4, 16), (64, 8, 8),
                                                (8, 4, 2), (7, 4, 2),
                                                (1, 4, 1)])
def test_paged_split_grid_covers_the_table(width, split, splits):
    """K4's grid is (heads, rows, splits), the splits sized from the
    table's width alone: ceil(width / split_pages)."""
    from flexflow_tpu_torch.ops.kernels import paged_attention as pk

    assert pk.split_grid(8, 12, width, split) == (12, 8, splits)


def test_paged_live_splits_at_the_decode_shape():
    """Splits that hold a live key: ceil(live count / span), the live
    count capped at the table's end, chunk tokens counted; a scratch row
    (seq_len 0) keeps one."""
    from flexflow_tpu_torch.ops.kernels import paged_attention as pk

    pos = np.array([0, 1, 63, 64, 1023, 2000])
    assert pk.live_splits(pos, 1, 16, 64, 4).tolist() == [1, 1, 1, 2, 16, 16]
    assert pk.live_splits(pos, 8, 16, 64, 4).tolist() == [1, 1, 2, 2, 16, 16]
    assert pk.live_splits(pos, 1, 16, 64, 1).tolist() == [1, 1, 4, 5, 64, 64]
    # the 8-slot decode shape with all rows at 1023: 16 live splits of 12
    # heads each, past two waves of 132 SMs
    assert 12 * pk.live_splits(np.full(8, 1023), 1, 16, 64).sum() >= 2 * 132


def test_paged_bound_counts_live_bytes():
    """K4's bytes bound: live K and V rows read once, plus q, the output,
    the table and seq_lens, over 3.35 TB/s."""
    b = chip_smoke.paged_bound(np.full(8, 1023), 16, 64, 12, 64, 4)
    assert b["live_tokens"] == 8 * 1024
    assert b["kv_bytes"] == 2 * 8 * 1024 * 12 * 64 * 4
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e9)
    idle = chip_smoke.paged_bound([1023] + [0] * 7, 16, 64, 12, 64, 4)
    assert idle["live_tokens"] == 1024 + 7


def test_phase_list_runs_the_vit_path_after_the_earlier_ones():
    phases = chip_smoke.ALL_PHASES.split(",")
    assert phases[:11] == ["kernels", "serve", "parity", "profile", "train",
                           "train_parity", "train_profile", "bn_kernels",
                           "resnet", "resnet_parity", "resnet_profile"]
    assert phases[11:14] == ["vit", "vit_parity", "vit_profile"]


def test_vit_op_table_adds_up_per_block():
    """12 blocks of 4 Reshape, 5 Transpose, 2 BatchMatmul, 3 Dropout, 6
    Linear, 2 LayerNorm, 2 adds, GELU and the scale, around a stem and
    head of 1 Reshape, 1 Transpose, 1 Dropout, 1 Linear, 1 LayerNorm,
    the position add, Conv2D, WeightOp and Mean."""
    per_block = {"reshape": 4, "transpose": 5, "batch_matmul": 2,
                 "dropout": 3, "linear": 6, "layer_norm": 2, "softmax": 1,
                 "element_binary": 2, "element_unary": 2}
    outside = {"reshape": 1, "transpose": 1, "dropout": 1, "linear": 1,
               "layer_norm": 1, "element_binary": 1, "conv2d": 1,
               "weight": 1, "mean": 1}
    want = {k: 12 * per_block.get(k, 0) + outside.get(k, 0)
            for k in set(per_block) | set(outside)}
    assert chip_smoke.VIT_OPS == want
    assert sum(want.values()) == 333


@pytest.mark.parametrize("name,kind", [
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "gemm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw",
     "conv"),
    ("void (anonymous namespace)::softmax_warp_forward<c10::BFloat16, "
     "c10::BFloat16, float, 8, false, false>", "softmax"),
    ("void at::native::(anonymous namespace)::distribution_elementwise_"
     "grid_stride_kernel<float, 4>", "rng"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
     "impl_nocast<at::native::direct_copy_kernel_cuda>>", "copy"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<c10::BFloat16>>", "elementwise"),
])
def test_vit_profile_kernel_kinds(name, kind):
    assert chip_smoke._vit_kernel_kind(name) == kind


def test_phase_list_ends_with_the_zoo_path():
    assert chip_smoke.ALL_PHASES.split(",")[14:17] == ["zoo", "zoo_parity",
                                                       "zoo_profile"]


def test_phase_list_ends_with_the_sequence_and_frontend_path():
    assert chip_smoke.ALL_PHASES.split(",")[17:22] == [
        "nmt", "generate", "keras", "onnx", "seq_parity"]


def test_search_phase_runs_last_over_the_hgx_node():
    """The search phase comes after every earlier one-card phase (only
    the store phase, which searches it again with a catalog, the
    resilience and supervised phases, the tools phase, which reads what
    those three wrote, and the multigpu phase, which trains the strategy
    it writes, follow),
    parses as a --phases entry, and searches BERT-base for the 8 GPUs of
    the committed one-node machine file, timing ops on the card."""
    import os

    from flexflow_tpu_torch.sim.machine_model import GpuNodeModel

    phases = chip_smoke.ALL_PHASES.split(",")
    assert phases[-6:] == ["search", "store", "resilience", "supervised",
                           "tools", "multigpu"]
    assert len(phases) == 30 and phases.count("search") == 1
    assert "`--phases search`" in chip_smoke.__doc__
    cfg = chip_smoke.search_config("/tmp/costs.json")
    assert (cfg.batch_size, cfg.device, cfg.search_budget) == (
        chip_smoke.TRAIN_BATCH, "cuda", chip_smoke.SEARCH_BUDGET)
    assert cfg.search_calibrate and cfg.should_calibrate()
    assert cfg.op_cost_cache_file == "/tmp/costs.json"
    assert os.path.isfile(cfg.machine_model_file)
    m = GpuNodeModel.from_file(cfg.machine_model_file)
    assert m.num_devices() == chip_smoke.SEARCH_DEVICES == 8
    assert chip_smoke.search_config("c", budget=0).search_budget == 0


def test_kernel_line_tallies_the_search_path():
    """K1-K3's rows carry the search phase's launches (None when the
    phase did not run)."""
    flash_main = {"kernel_ms": {k: 1.0 for k in ("K1", "K2", "K3")},
                  "plain_ms": {k: 2.0 for k in ("K1", "K2", "K3")},
                  "library_ms": {k: 1.5 for k in ("K1", "K2", "K3")},
                  "share_of_bound": {k: 0.3 for k in ("K1", "K2", "K3")},
                  "bounds": chip_smoke.flash_bounds(*SHAPE)}
    flash = {"main": {"float32": flash_main, "bfloat16": flash_main},
             "worst": {k: {"float32": (1e-6, 1e-7)}
                       for k in ("K1", "K2", "K3")}}
    kern = {"worst": {"float32": 1e-6}, "kernel_ms": 0.02, "event_ms": 0.03,
            "plain_ms": 0.3, "bound_ms": 0.01, "bound_by": "bytes",
            "share_of_bound": 0.4, "library_ms": 0.2, "split_pages": 8,
            "grid": [1, 1, 1]}
    search = {"flash_launches": {"K1": 30, "K2": 12, "K3": 12}}
    rows = chip_smoke.kernel_line(kern, flash, None, None, None, None,
                                  "card", None, search)["kernels"]
    got = {r["id"]: r.get("launches_search") for r in rows}
    assert got == {"K4": None, "K1": 30, "K2": 12, "K3": 12}
    rows = chip_smoke.kernel_line(kern, flash, None, None, None, None,
                                  "card")["kernels"]
    assert all(r.get("launches_search") is None for r in rows)


def test_zoo_table_is_the_examples_configuration():
    """Every native example's model, at its example's batch: -b 64 but
    the Transformer's -b 8 and build_moe_encoder's own 8."""
    assert sorted(chip_smoke.ZOO) == [
        "alexnet", "candle_uno", "dlrm", "inception_v3", "mlp",
        "moe_encoder", "moe_mlp", "resnet50", "resnext50", "transformer",
        "xdl"]
    batches = {k: v[1] for k, v in chip_smoke.ZOO.items()}
    assert batches.pop("transformer") == 8
    assert batches.pop("moe_encoder") == 8
    assert set(batches.values()) == {64}
    for name, (example, *_rest) in chip_smoke.ZOO.items():
        if example.startswith("examples/"):
            assert (ROOT / example).is_file(), name


@pytest.mark.parametrize("name,ops,params", [
    ("inception_v3", 123, 21_788_842),
    ("candle_uno", 33, None),
    ("transformer", 38, None),
])
def test_zoo_graphs_at_full_width(name, ops, params):
    """The full-width graphs the zoo phase builds (on the CPU here,
    without compile's weights): Inception-v3's 123 ops, CANDLE-Uno's
    ~0.5 B parameters, the Transformer's 12 layers at seq 512."""
    from flexflow_tpu_torch import FFConfig, FFModel

    _, b, build, *_ = chip_smoke.ZOO[name]
    ff = FFModel(FFConfig(batch_size=b, device="cpu"))
    build(ff, b)
    assert len(ff.layers.ops) == ops
    n = sum(int(np.prod(s.shape.logical_shape)) for op in ff.layers.ops
            for s in op.weight_specs)
    if params is not None:
        assert n == params
    if name == "candle_uno":
        assert 0.45e9 < n < 0.55e9
    if name == "transformer":
        shape = ff.layers.source_ops()[0].outputs[0].shape.logical_shape
        assert shape == (8, 512, 1024)


def test_zoo_data_shapes_follow_the_graph():
    from flexflow_tpu_torch import FFConfig, FFModel

    for name in ("dlrm", "xdl", "mlp", "moe_encoder"):
        _, b, build, *_ = chip_smoke.ZOO[name]
        ff = FFModel(FFConfig(batch_size=b, device="cpu"))
        build(ff, b)
        bb, (x, y) = chip_smoke.zoo_data(name, 2)
        assert bb == b and len(y) == 2 * b
        for op in ff.layers.source_ops():
            shape = op.outputs[0].shape.logical_shape
            assert x[op.name].shape == (2 * b,) + tuple(shape[1:])


def test_layout_plan_of_the_zoo_cnns():
    """One conversion to channels_last at the input and one back before
    the head, for every CNN of the zoo."""
    import torch

    import flexflow_tpu_torch.model as M

    real = M.resolve_device
    M.resolve_device = lambda name: torch.device("cpu")
    try:
        for name in ("inception_v3", "resnext50", "resnet50", "alexnet"):
            ff = chip_smoke.build_zoo_model(name, batch=2)
            assert chip_smoke.layout_conversions(ff) == {"to_nhwc": 1,
                                                         "to_nchw": 1}
    finally:
        M.resolve_device = real


def test_moe_routing_counts_drops_and_load():
    import torch

    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=4, device="cpu"))
    x = ff.create_tensor([4, 3], name="x")
    assign = ff.create_tensor([4, 2], dtype="int32", name="a")
    op = ff.group_by(x, assign, 2, 0.75).owner_op  # capacity 3
    a = torch.tensor([[0, 1]] * 4, dtype=torch.int32)
    rec = chip_smoke.moe_routing(torch, [(op, a), (op, a)])[op.name]
    assert rec["capacity"] == 3 and rec["pairs"] == 16
    assert rec["dropped"] == 4 and rec["dropped_share"] == 0.25
    assert rec["load"] == [8, 8] and rec["load_share"] == [0.5, 0.5]


def test_tiny_feed_keeps_ids_inside_their_tables():
    from flexflow_tpu_torch import FFConfig, FFModel, models

    ff = FFModel(FFConfig(batch_size=8, device="cpu"))
    models.build_dlrm(ff, batch_size=8,
                      **chip_smoke.ZOO_TINY["build_dlrm"])
    ff.compile(loss_type="mean_squared_error_avg",
               metrics=["mean_squared_error"])
    feed, y = chip_smoke._tiny_feed(ff, np.random.RandomState(0))
    assert feed["sparse_input_0"].max() < 50 and y.shape == (8, 2)
    assert feed["dense_input"].dtype == np.float32


class _Span:
    def __init__(self, start, end):
        self.start, self.end = start, end

    def elapsed_us(self):
        return self.end - self.start


class _Evt:
    def __init__(self, start, end, name="k", stream=7):
        self.time_range = _Span(start, end)
        self.name = name
        self.device_resource_id = stream


def test_device_busy_is_the_union_over_streams():
    """A loader copy on its own stream that overlaps a kernel adds no
    busy time; by_stream keeps each stream's sum and its copies."""
    events = [_Evt(0, 10), _Evt(5, 12, "Memcpy HtoD (Pinned -> Device)",
                                stream=20), _Evt(20, 25)]
    assert chip_smoke.device_busy_us(events) == 17
    rows = chip_smoke.by_stream(events, steps=1)
    assert rows["7"]["ms_per_step"] == pytest.approx(0.015)
    assert rows["20"]["h2d_ms_per_step"] == pytest.approx(0.007)
    assert rows["7"]["h2d_ms_per_step"] == 0


def _profiles(monkeypatch, records: list):
    """torch.profiler.profile replaced by one that holds records[i]
    kernel records (each 2 us) in its i-th profile, and a torch whose
    synchronize does nothing."""
    import types

    import torch.profiler

    class Profile:
        def __init__(self, activities):
            self.n = records.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            evts = [_Evt(0, 2, "paged_attention_kernel<4>")
                    for _ in range(self.n)] + [_Evt(0, 9, "fill")]
            for e in evts:
                e.device_type = "DeviceType.CUDA"
            return evts

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(chip_smoke, "PROFILER_DROPS", [])
    return types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None))


class _Flush:
    def zero_(self):
        pass


def test_profiled_ms_retakes_a_profile_that_lost_records(monkeypatch):
    """A profile holding 11 of 30 records of the kernel is logged and
    taken again; the next, with all 30, gives the median."""
    fake = _profiles(monkeypatch, [11, 30])
    ms = chip_smoke.profiled_ms(fake, lambda: None, _Flush(),
                                "paged_attention_kernel")
    assert ms == pytest.approx(0.002)
    assert chip_smoke.PROFILER_DROPS == [{
        "tag": "paged_attention_kernel", "attempt": 1, "records": 11,
        "launches": 30}]


@pytest.mark.parametrize("records", [[11, 11, 11], [31, 29, 0]])
def test_profiled_ms_raises_when_every_profile_miscounts(monkeypatch,
                                                         records):
    fake = _profiles(monkeypatch, list(records))
    with pytest.raises(RuntimeError, match="expected 30, in each of 3"):
        chip_smoke.profiled_ms(fake, lambda: None, _Flush(),
                               "paged_attention_kernel")
    assert [d["records"] for d in chip_smoke.PROFILER_DROPS] == records


@pytest.mark.parametrize("name,kind", [
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<"
     "at::native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 4, "
     "64, 64>", "concat"),
    ("void at::native::(anonymous namespace)::avg_pool2d_backward_out_cuda"
     "_frame_nhwc<float, float, int>(int, float const*)", "pool"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<float,"
     " int>(float const*, int)", "pool"),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*, float2*)",
     "conv"),
    ("void fft2d_r2c_32x32<float, false, 0u, false>(float2*)", "conv"),
])
def test_zoo_kernel_kinds(name, kind):
    assert chip_smoke._vit_kernel_kind(name) == kind


def test_loader_steps_run_after_a_warm_step():
    """The profiles' window: `steps` train steps fed by one loader, its
    first batch spent on a warm step before the window."""
    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=4, device="cpu"))
    ff.softmax(ff.dense(ff.create_tensor([4, 3], name="input"), 2))
    ff.compile()
    calls = []
    step = ff.train_step
    ff.train_step = lambda x, y: calls.append(y.tolist()) or step(x, y)
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    y = np.arange(20, dtype=np.int32) % 2
    run = chip_smoke.loader_steps(ff, x, y, 4, 3)
    assert len(calls) == 1
    run()
    assert calls == [list(y[i:i + 4]) for i in range(0, 16, 4)]


def test_nmt_sizing_at_luong_widths():
    """Luong et al.'s widths: ~1.49 TFLOP forward (the gate products
    0.82, the vocabulary projection 0.64), ~4.46 per train step."""
    f = chip_smoke.nmt_flops(128, **chip_smoke.NMT_WIDTH)
    assert f["lstm"] == 8 * 2 * 128 * 50 * 2000 * 4000
    assert f["vocab_proj"] == 2 * 128 * 50 * 1000 * 50000
    assert f["forward"] == pytest.approx(1.486e12, rel=1e-3)
    assert f["train_step"] == 3 * f["forward"]
    assert chip_smoke.NMT_BATCH == 128


def test_nmt_data_is_a_shifted_copy_task():
    x, y = chip_smoke.nmt_data(np.random.RandomState(0), 6,
                               **chip_smoke.NMT_TINY)
    assert x["src"].shape == (6, 6) and x["tgt"].shape == y.shape == (6, 5)
    assert (x["tgt"][:, 0] == 1).all()
    np.testing.assert_array_equal(x["tgt"][:, 1:], y[:, :-1])
    assert y.max() < chip_smoke.NMT_TINY["tgt_vocab"]
    assert x["src"].dtype == y.dtype == np.int32


def test_dense_twin_caches_of_gpt2_small_hold_604_mb():
    """12 layers x k and v x [8, 1024, 12, 64] float32, from the decode
    graph's state specs (not allocated)."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import build_gpt

    ff = FFModel(FFConfig(batch_size=8, device="cpu"))
    w = dict(chip_smoke.WIDTH, seq_length=1)
    build_gpt(ff, batch_size=8, max_positions=1024, decode_max_seq=1024,
              **w)
    n = sum(int(np.prod(s.shape.logical_shape)) * 4 for op in ff.layers.ops
            for s in op.weight_specs if s.name in ("k_cache", "v_cache"))
    assert n == 2 * 12 * 8 * 1024 * 768 * 4
    assert round(n / 1e6) == 604


def test_first_divergence_is_the_earliest_position():
    a = np.zeros((3, 6), np.int32)
    b = a.copy()
    assert chip_smoke.first_divergence(a, b, 2) is None
    b[2, 3] = b[0, 5] = b[1, 1] = 1
    assert chip_smoke.first_divergence(a, b, 2) == (2, 3)


def test_greedy_forms_must_be_equal():
    """Any generated token that differs fails, at its row and position;
    the prompt is not compared."""
    want = np.array([[3, 5, 7, 9], [1, 2, 4, 8]], np.int32)
    chip_smoke.greedy_equal("x", want, want.copy(), 2)
    got = want.copy()
    got[0, 1] = 0
    chip_smoke.greedy_equal("x", want, got, 2)
    got[1, 3] = 7
    with pytest.raises(RuntimeError, match="row 1, position 3: 7 against 8"):
        chip_smoke.greedy_equal("x", want, got, 2)


def test_record_grads_holds_the_steps_gradients():
    """The recorded gradients are the ones the update applied (SGD moves
    each weight by -lr x grad); unwrapping restores the class's update;
    the CPU reference of the nmt phase, from the same weights and batch,
    gives the same gradients and loss."""
    ff = chip_smoke.build_nmt_model("cpu", 4, chip_smoke.NMT_TINY)
    x, y = chip_smoke.nmt_data(np.random.RandomState(1), 4,
                               **chip_smoke.NMT_TINY)
    init = ff.get_weights()
    grads = chip_smoke.record_grads(ff)
    loss = float(ff.train_step(x, y)["loss"])
    del ff.executor.optimizer.update
    assert "update" not in vars(ff.executor.optimizer)
    after = ff.get_weights()
    assert set(grads) == set(init)
    for op, e in init.items():
        for k, w in e.items():
            np.testing.assert_allclose(after[op][k] - w,
                                       -chip_smoke.NMT_LR * grads[op][k],
                                       rtol=0, atol=1e-7)
    ref = chip_smoke.nmt_cpu_grads(init, x, y, chip_smoke.NMT_TINY)
    assert ref["loss"] == loss
    diff = chip_smoke.grad_rel_diff(grads, ref["grads"])
    assert len(diff) == sum(len(e) for e in init.values())
    assert max(diff.values()) == 0.0


def test_grad_rel_diff_is_relative_to_the_largest_gradient():
    ref = {"a": {"kernel": np.array([2.0, -4.0]), "bias": np.zeros(2)}}
    got = {"a": {"kernel": np.array([2.0, -3.0]),
                 "bias": np.array([0.0, 1e-3])}}
    diff = chip_smoke.grad_rel_diff(got, ref)
    assert diff == {"a.kernel": 0.25, "a.bias": pytest.approx(1e27)}
    assert chip_smoke.grad_rel_diff(ref, ref) == {"a.kernel": 0.0,
                                                  "a.bias": 0.0}


def test_keras_table_is_the_examples():
    """Each examples/python/keras/*.py model at batch 64, and the LSTM
    classifier at batch 32; each builds and compiles on the CPU, and its
    data has the model's input shape."""
    import flexflow_tpu_torch.keras as K
    from flexflow_tpu_torch import FFConfig

    table = chip_smoke.keras_models(K)
    examples = {p.stem for p in (ROOT / "examples" / "python"
                                 / "keras").glob("*.py")}
    assert set(table) == examples | {"lstm_reuters"}
    for name, (build, opt, loss, metrics, kind, b) in table.items():
        assert b == (32 if name == "lstm_reuters" else 64)
        m = build(FFConfig(batch_size=b, device="cpu"))
        m.compile(optimizer=opt, loss=loss, metrics=metrics)
        x, y, _ = chip_smoke.keras_data(K.datasets, kind, 2 * b)
        src = m.ffmodel.layers.source_ops()[0].outputs[0].shape
        assert x.shape[1:] == src.logical_shape[1:], name
        assert len(x) == len(y) == 2 * b or kind == "cifar10"
    x, y, synthetic = chip_smoke.keras_data(K.datasets, "reuters_ids", 4)
    assert x.shape == (4, 200) and x.max() < 10000 and y.max() < 46


def test_multigpu_legs_follow_the_issue():
    """Five legs of 4 ranks (DP x TP, DP x SP, ZeRO-3 and ZeRO-2 under
    Adam, the CNN), the searched strategy over 8, five pipeline legs of 4 (data 2
    x pipe 2 with and without remat, pipe 4, the demo under 1F1B, the
    search's cheapest pipeline), four MoE legs of 4 (data 4, expert
    4, data 2 x expert 2, the search's), four legs of 4 of factored
    views and two slices, the checkpoint leg of 4, the supervisor's
    two legs of 4 (elastic, preempt_barrier) and Keras compile(devices)
    on 4 (keras_devices), each with its strategy."""
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}
    assert [leg["ranks"] for leg in chip_smoke.MULTIGPU_LEGS] == \
        [4, 4, 4, 4, 4, chip_smoke.SEARCH_DEVICES] + [4] * 17
    assert [leg["name"] for leg in chip_smoke.MULTIGPU_LEGS][-12:-8] == \
        ["moe_dp4", "ep4", "dp2_ep2", "moe_searched"]
    assert chip_smoke.MOE == dict(hidden_size=768, num_layers=12,
                                  num_heads=12, num_exp=8, num_select=2,
                                  alpha=2.0, lambda_bal=0.04, num_classes=2)
    dp4 = chip_smoke._multigpu_strategy(legs["moe_dp4"], {})
    assert dp4.mesh_axes == {"data": 4} and not dp4.shard_configs
    ep4 = chip_smoke._multigpu_strategy(legs["ep4"], {})
    assert ep4.mesh_axes == {"expert": 4} and not ep4.edge_ops
    assert len(ep4.shard_configs) == 24
    assert {sc.expert for sc in ep4.shard_configs.values()} == {4}
    mixed = chip_smoke._multigpu_strategy(legs["dp2_ep2"], {})
    assert mixed.mesh_axes == {"data": 2, "expert": 2}
    assert mixed.edge_ops["__inputs__"] == [("repartition",
                                             {"dim": 0, "degree": 2})]
    assert chip_smoke.expert_split(mixed) == 2
    assert chip_smoke.expert_split(dp4) == 1
    assert all(leg["reference"] == "moe" for leg in chip_smoke.MULTIGPU_LEGS
               if leg.get("strategy", [""])[0].startswith("moe"))
    tp = chip_smoke._multigpu_strategy(legs["dp_tp"], {})
    assert tp.mesh_axes == {"data": 2, "model": 2}
    sp = chip_smoke._multigpu_strategy(legs["dp_sp"], {})
    assert sp.mesh_axes == {"data": 2, "seq": 2}
    assert legs["dp_zero3"]["zero"] == 3
    assert legs["dp_zero3"]["optimizer"] == "adam"
    assert {k: v for k, v in legs["dp_zero2"].items() if k != "name"} == {
        k: v for k, v in legs["dp_zero3"].items() if k != "name"} | {
        "zero": 2}
    assert "`--phases multigpu`" in chip_smoke.__doc__
    pp = chip_smoke._multigpu_strategy(legs["pp_dp"], {})
    assert pp.mesh_axes == {"data": 2, "pipe": 2}
    assert pp.pipeline == {"degree": 2, "num_microbatches": 4,
                           "axis": "pipe", "dp_axis": "data"}
    assert pp.edge_ops["__inputs__"] == [("repartition",
                                          {"dim": 0, "degree": 2})]
    pp4 = chip_smoke._multigpu_strategy(legs["pp4"], {})
    assert pp4.mesh_axes == {"pipe": 4} and pp4.pipeline["dp_axis"] is None
    assert legs["pp_dp_remat"]["remat"] is True
    assert chip_smoke._multigpu_strategy(
        legs["pp_dp_remat"], {}).to_json() == pp.to_json()
    assert chip_smoke._multigpu_strategy(legs["pp_1f1b"], {}) is None
    assert legs["pp_1f1b"]["strategy"] == ["demo", 1, 4, 8]
    assert chip_smoke.DEMO == dict(layers=12, hidden=768, ffn=3072,
                                   num_heads=12, num_classes=2, lr=0.01)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "pp.json")
        pp4.save(path)
        got = chip_smoke._multigpu_strategy(legs["pp_searched"],
                                            {"pipeline_file": path})
    assert got.to_json() == pp4.to_json()


def test_factored_and_slice_legs_follow_the_issue():
    """factored_tp4 (attention at channel 4 on model1 + model0, ffn1 at
    2 on model1 over {model0: 2, model1: 2}), slices2_dp4 (data 4 over 2
    slices, with its flat run), slices2_zero1 (ZeRO-1 under Adam) and
    slices2_searched (the Unity search's file), 4 ranks each, BERT
    against its one-card run; each launches K1-K3 12 times per rank per
    step: 3 local heads x 8 rows, or 12 heads x 2 rows, [24, 2048, 64]."""
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}
    names = ["factored_tp4", "slices2_dp4", "slices2_zero1",
             "slices2_searched"]
    assert [leg["name"] for leg in chip_smoke.MULTIGPU_LEGS][-8:-4] == names
    assert [legs[n].get("slices", 1) for n in names] == [1, 2, 2, 2]
    assert [legs[n]["reference"] for n in names] == [
        "bert_sgd", "bert_sgd", "bert_adam", "bert_sgd"]
    assert legs["slices2_dp4"]["flat_baseline"] is True
    assert legs["slices2_zero1"]["zero"] == 1
    assert legs["slices2_zero1"]["optimizer"] == "adam"
    f = chip_smoke._multigpu_strategy(legs["factored_tp4"], {})
    assert f.mesh_axes == {"model0": 2, "model1": 2} and not f.edge_ops
    assert {k: v.channel for k, v in f.shard_configs.items()} == {
        **{f"attn_{i}": 4 for i in range(12)},
        **{f"ffn1_{i}": 2 for i in range(12)}}
    dp = chip_smoke._multigpu_strategy(legs["slices2_dp4"], {})
    assert dp.mesh_axes == {"data": 4}
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "s.json")
        dp.save(path)
        got = chip_smoke._multigpu_strategy(legs["slices2_searched"],
                                            {"slices_strategy_file": path})
    assert got.to_json() == dp.to_json()
    for name in names:
        want = chip_smoke.expected_launches(legs[name], dp if name !=
                                            "factored_tp4" else f)
        assert want == {"K1": 12, "K2": 12, "K3": 12}
    # the local flash shape: heads per rank x rows per rank
    heads, rows = chip_smoke.BERT["num_heads"], chip_smoke.TRAIN_BATCH
    assert heads // 4 * rows == heads * (rows // 4) == 24
    assert chip_smoke.HIER_FLAT_TOL == {"rtol": 2e-5, "atol": 2e-6}
    assert chip_smoke.SLICES_MACHINE == "hgx_h100_16"
    assert "factored_tp4,slices2_dp4,slices2_zero1,slices2_searched" in \
        " ".join(chip_smoke.__doc__.split())


def _slice_report(rank, flat_w=None, mesh=None, hier="data", wus=None):
    rep = _rank_report(rank)
    rep.update(exec_mesh=mesh or {"slice": 2, "data": 2}, hier_axis=hier,
               wus_axis=wus, mesh={"data": 4},
               collective_bytes_per_step={"update.all_gather": 1.0})
    if flat_w is not None:
        rep["flat"] = {"losses": [0.69, 7.26], "step_s": [0.3, 0.25],
                       "collective_bytes_per_step": {"update.all_reduce": 2.0}}
        if rank == 0:
            rep["flat"].update(chip_smoke.hier_flat_diff(*flat_w))
    return rep


def test_slice_record_checks_the_mesh_and_the_flat_run():
    """slices2_dp4's record holds its two-level mesh and its flat run:
    hierarchical and flat weights within HIER_FLAT_TOL pass, beyond it
    (a skipped sum between the slices moves a weight by ~1e-3) fault;
    a rank on the flat mesh faults; ZeRO-1 must run over the remainder
    with no hier_axis."""
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}
    ref = {"losses": [0.69, 7.2601], "step_s": [1.0, 0.3],
           "last_step_moves": {"w": 1e-3}}
    w = {"op": {"k": np.array([1.0, -0.5, 2e-3])}}
    near = {"op": {"k": np.array([1.0 + 1e-5, -0.5, 2e-3 + 1e-6])}}
    far = {"op": {"k": np.array([1.0, -0.5 + 1e-3, 2e-3])}}

    def rec(name, reports):
        return chip_smoke._multigpu_record(legs[name], reports, ref, "gloo",
                                           1, 50.0, "", {})

    ok = rec("slices2_dp4", [_slice_report(r, (near, w)) for r in range(4)])
    assert ok["faults"] == [], ok["faults"]
    assert ok["exec_mesh"] == {"slice": 2, "data": 2}
    assert ok["flat"]["step_ms"] == [300.0, 250.0]
    assert ok["slices_note"] == chip_smoke.SLICES_NOTE
    assert len(ok["collective_bytes_per_step_per_rank"]) == 4
    apart = rec("slices2_dp4", [_slice_report(r, (far, w)) for r in range(4)])
    assert any("hierarchical and flat" in f for f in apart["faults"])
    flat_mesh = rec("slices2_dp4", [_slice_report(r, (near, w),
                                                  mesh={"data": 4},
                                                  hier=None)
                                    for r in range(4)])
    assert len(flat_mesh["faults"]) == 4
    zero = rec("slices2_zero1", [_slice_report(r, hier=None, wus="data")
                                 for r in range(4)])
    assert zero["faults"] == [] and zero["wus_axis"] == "data"
    wrong = rec("slices2_zero1", [_slice_report(r) for r in range(4)])
    assert len(wrong["faults"]) == 4
    assert chip_smoke.hier_flat_diff(w, w)["weights_diff"] == 0.0


@pytest.mark.parametrize("layers,stages,m,schedule,remat,want", [
    (12, 2, 4, "gpipe", False, (30, 30, 30)),   # pp_dp: 6 blocks x 5 ticks
    (12, 4, 4, "gpipe", False, (21, 21, 21)),   # pp4: 3 x 7
    (12, 2, 4, "gpipe", True, (60, 30, 30)),    # remat recomputes K1
    (12, 4, 8, "gpipe", False, (33, 33, 33)),   # the demo's GPipe: 3 x 11
    (12, 4, 8, "1f1b", False, (48, 24, 24)),    # 8 x 3, K1 twice
    (12, 1, 8, "gpipe", False, (96, 96, 96)),   # one stage: L x M
])
def test_pipeline_launch_formula(layers, stages, m, schedule, remat, want):
    got = chip_smoke.pipeline_launches(layers, stages, m, schedule, remat)
    assert (got["K1"], got["K2"], got["K3"]) == want


def _rank_report(rank, k=12, p1=0, losses=(0.69, 7.26), weights=1e-7):
    return {"rank": rank, "losses": list(losses), "step_s": [3.0, 0.2],
            "launches_per_step": {"K1": k, "K2": k, "K3": k, "P1": p1},
            "peak_memory_gb": 4.0, "opt_state_bytes": 0, "zero_stage": 0,
            "zero_fallback_leaves": [], "mesh": {"data": 2, "seq": 2},
            "weights_diff": weights, "worst_weight": "w"}


def test_multigpu_record_checks_each_leg():
    """A leg's record holds its checks: losses as error over max(1,
    |loss|), K1-K3 at 12 x sp per rank per step, the backend's note; the
    Adam leg's weight limit passes the H100's 1.11e-4, fails a skipped
    update's ~alpha (1e-3), and faults when the one-card run's last
    update moved no weight past it."""
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}
    ref = {"losses": [0.69, 7.2601], "step_s": [1.0, 0.3],
           "last_step_moves": {"w": 1e-3, "b": 5e-5}}
    ok = chip_smoke._multigpu_record(
        legs["dp_sp"], [_rank_report(r, k=24) for r in range(4)], ref,
        "gloo", 1, 50.0, "", {})
    assert ok["faults"] == [] and ok["predicted_step_ms"] is None
    assert "gloo" in ok["prediction_note"]
    assert ok["step_ms"] == [3000.0, 200.0]
    bad = chip_smoke._multigpu_record(
        legs["dp_sp"], [_rank_report(r, k=12) for r in range(4)], ref,
        "gloo", 1, 50.0, "", {})
    assert len(bad["faults"]) == 4  # every rank's launches
    off = chip_smoke._multigpu_record(
        legs["dp_tp"], [_rank_report(r, losses=(0.69, 7.27))
                        for r in range(4)], ref, "gloo", 1, 50.0, "", {})
    assert any("losses" in f for f in off["faults"])
    zero = [_rank_report(r, weights=1.11e-4) for r in range(4)]
    adam = chip_smoke._multigpu_record(legs["dp_zero3"], zero, ref, "gloo",
                                       1, 50.0, "", {})
    assert adam["faults"] == [] and adam["weight_tolerance"] == 3e-4
    assert adam["skipped_last_update_reads"] == 1e-3
    assert adam["weights_whose_last_update_the_tolerance_sees"] == [1, 2]
    skipped = chip_smoke._multigpu_record(
        legs["dp_zero3"], [_rank_report(r, weights=1e-3) for r in range(4)],
        ref, "gloo", 1, 50.0, "", {})
    assert any("weights" in f for f in skipped["faults"])
    blind = chip_smoke._multigpu_record(
        legs["dp_zero3"], zero, dict(ref, last_step_moves={"w": 2e-4}),
        "gloo", 1, 50.0, "", {})
    assert any("skipped last update" in f for f in blind["faults"])
    line = chip_smoke._multigpu_launches({"legs": [ok]}, "K1")
    assert line == {"dp_sp": [24, 24, 24, 24]}
    assert chip_smoke._multigpu_launches(None, "K1") is None


def _pp_report(rank, k=(30, 30, 30), **kw):
    rep = _rank_report(rank, **kw)
    rep["launches_per_step"] = dict(zip(("K1", "K2", "K3"), k), P1=0)
    rep["mesh"] = {"data": 2, "pipe": 2}
    return rep


def test_multigpu_record_checks_the_pipeline_legs():
    """A pipeline leg's record holds its launch formula's counts and the
    search's price of its strategy, whatever the backend; the demo's
    record holds GPipe beside 1F1B, each against one card and against
    each other."""
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}
    ref = {"losses": [0.69, 7.2601], "step_s": [1.0, 0.3],
           "last_step_moves": {"w": 1e-3}}
    pp = chip_smoke.pipeline_strategy(2, 2, 4)
    import json
    job = {"pipelines": [{"strategy": json.loads(pp.to_json()),
                          "predicted_step_ms": 90.0,
                          "event_predicted_step_ms": 95.0}]}
    ok = chip_smoke._multigpu_record(
        legs["pp_dp"], [_pp_report(r) for r in range(4)], ref, "gloo", 1,
        50.0, "", job)
    assert ok["faults"] == [] and ok["predicted_step_ms"] == 90.0
    assert ok["event_predicted_step_ms"] == 95.0
    assert "gloo" in ok["prediction_note"]
    assert ok["expected_launches_per_rank_per_step"] == {
        "K1": 30, "K2": 30, "K3": 30}
    remat = chip_smoke._multigpu_record(
        legs["pp_dp_remat"], [_pp_report(r) for r in range(4)], ref,
        "nccl", 4, 50.0, "", job)
    assert len(remat["faults"]) == 4  # K1 must run twice per block
    assert "remat" in remat["prediction_note"]
    off = chip_smoke._multigpu_record(
        legs["pp4"], [_pp_report(r) for r in range(4)], ref, "nccl", 4,
        50.0, "", job)
    assert off["predicted_step_ms"] is None  # not a priced candidate
    assert len(off["faults"]) == 4

    from types import SimpleNamespace

    def counted(k1, k2):
        """What leg_launches reports after 2 steps of k1, k2, k2
        launches each (P1 0)."""
        fa = SimpleNamespace(flash_fwd=SimpleNamespace(launches=2 * k1),
                             flash_bwd_dq=SimpleNamespace(launches=2 * k2),
                             flash_bwd_dkv=SimpleNamespace(launches=2 * k2))
        bk = SimpleNamespace(bn_apply=SimpleNamespace(launches=0))
        return chip_smoke.leg_launches(fa, bk, 2)

    def demo(rank, gpipe_losses=(0.69, 7.2601), k=(48, 24, 24)):
        rep = _pp_report(rank, k=k)
        rep["launches_per_step"] = counted(k[0], k[1])
        rep["gpipe"] = {"losses": list(gpipe_losses), "step_s": [2.0, 0.5],
                        "peak_memory_gb": 9.0, "weights_diff": 1e-7,
                        "launches_per_step": counted(33, 33)}
        rep["schedules_weights_diff"] = 1e-7
        return rep

    d = chip_smoke._multigpu_record(
        legs["pp_1f1b"], [demo(r) for r in range(4)], ref, "nccl", 4, 50.0,
        "", job)
    assert d["faults"] == [] and d["predicted_step_ms"] is None
    assert d["gpipe"]["step_ms"] == [2000.0, 500.0]
    assert d["gpipe"]["peak_memory_gb_per_rank"] == [9.0] * 4
    apart = chip_smoke._multigpu_record(
        legs["pp_1f1b"], [demo(r, gpipe_losses=(0.69, 7.3))
                          for r in range(4)], ref, "nccl", 4, 50.0, "", job)
    assert any("GPipe" in f for f in apart["faults"])
    assert any("1F1B against GPipe" in f for f in apart["faults"])
    line = chip_smoke._multigpu_launches({"legs": [d]}, "P1")
    assert line == {"pp_1f1b": [0.0] * 4}


def test_every_leg_reports_every_kernel_count():
    """Each leg's report holds K1-K3 and P1 per step (the kernels line
    reads all four of every leg, the demo's too), counted from 0."""
    from types import SimpleNamespace

    fa = SimpleNamespace(flash_fwd=SimpleNamespace(launches=5),
                         flash_bwd_dq=SimpleNamespace(launches=5),
                         flash_bwd_dkv=SimpleNamespace(launches=5))
    bk = SimpleNamespace(bn_apply=SimpleNamespace(launches=3))
    chip_smoke.reset_leg_launches(fa, bk)
    fa.flash_fwd.launches, fa.flash_bwd_dq.launches = 96, 48
    fa.flash_bwd_dkv.launches = 48
    got = chip_smoke.leg_launches(fa, bk, 2)
    assert got == {"K1": 48.0, "K2": 24.0, "K3": 24.0, "P1": 0.0}
    line = {"legs": [{"leg": "pp_1f1b", "launches_per_rank_per_step":
                      [got] * 4}]}
    for kid in ("K1", "K2", "K3", "P1"):
        assert len(chip_smoke._multigpu_launches(line, kid)["pp_1f1b"]) == 4


def test_moe_launches_follow_the_formula():
    """K1-K3 per rank per step on the MoE legs: one each per attention
    layer (12), whatever splits the experts; per ring block where a
    strategy shards the sequence."""
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}
    for name in ("moe_dp4", "ep4", "dp2_ep2"):
        strat = chip_smoke._multigpu_strategy(legs[name], {})
        assert chip_smoke.expected_launches(legs[name], strat) == {
            "K1": 12, "K2": 12, "K3": 12}
    from flexflow_tpu_torch.strategy import Strategy

    seq = Strategy(mesh_axes={"data": 2, "seq": 2})
    assert chip_smoke.expected_launches(legs["moe_searched"], seq)["K1"] == 24


def _moe_reports(tmp, flip_gap=None, balance=(0.48, 0.47), split=2,
                 earlier=None):
    """4 rank reports of a MoE leg and its one-card record, routing in
    npz files under tmp: 2 steps x 12 layers x 16 tokens, rank r holding
    tokens 4r..4r+3; with flip_gap, rank 0's token 1 takes its third
    choice for its second at layer 3 of step 1, whose one-card gap
    between them is flip_gap; with earlier = (layer, token), that token
    flips its second choice at that layer of step 1 too, at a gap of
    1e-7."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 8, (2, 12, 16, 2)).astype(np.int16)
    top3 = -np.sort(-rng.rand(2, 12, 16, 3), axis=-1)
    got = ids.copy()
    if flip_gap is not None:
        third = (int(ids[1, 3, 1, 1]) + 1) % 8
        got[1, 3, 1, 1] = third
        top3[1, 3, 1, 2] = top3[1, 3, 1, 1] - flip_gap
    if earlier is not None:
        layer, tok = earlier
        got[1, layer, tok, 1] = (int(ids[1, layer, tok, 1]) + 1) % 8
        top3[1, layer, tok, 2] = top3[1, layer, tok, 1] - 1e-7
    np.savez(f"{tmp}/ref.npz", ids=ids, top3=top3,
             start=np.zeros((2, 12), int), aux=np.zeros((2, 12)))
    ref = {"losses": [0.69, 0.68], "step_s": [1.0, 0.3],
           "last_step_moves": {"w": 1e-3}, "routing_file": f"{tmp}/ref.npz",
           "balance_losses": [0.48, 0.47],
           "expert_weight_bytes": 226525184, "dropped_pair_share": [0.0] * 2}
    reports = []
    for r in range(4):
        path = f"{tmp}/leg_{r}.npz"
        np.savez(path, ids=got[:, :, 4 * r:4 * r + 4],
                 start=np.full((2, 12), 4 * r), aux=np.zeros((2, 12)))
        rep = _rank_report(r, losses=(0.69, 0.68))
        rep.update(mesh={"data": 2, "expert": 2}, routing_file=path,
                   expert_weight_bytes=226525184 // split,
                   balance_losses=list(balance),
                   collective_bytes_per_step={
                       "GroupBy.all_to_all_v": 5e7, "Aggregate.all_reduce":
                       0.0, "LayerNorm.all_gather": 1e6})
        reports.append(rep)
    return reports, ref


def test_moe_record_checks_flips_balance_and_expert_bytes(tmp_path):
    """A MoE leg passes with its routing equal to one card's, or a flip
    at a gate gap within MOE_FLIP_GAP; it fails on a flip at a wider
    gap, on a balance loss off the one-card run's, and on expert weights
    that are not 1/E of one card's per rank."""
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}

    def record(**kw):
        reps, ref = _moe_reports(str(tmp_path), **kw)
        return chip_smoke._multigpu_record(legs["dp2_ep2"], reps, ref,
                                           "gloo", 1, 50.0, "", {})

    ok = record()
    assert ok["faults"] == [] and ok["moe"]["flip_count"] == 0
    assert ok["moe"]["expert_split"] == 2
    assert ok["moe"]["moe_collective_bytes_per_step_total"] == [5e7] * 4
    assert ok["expected_launches_per_rank_per_step"] == {
        "K1": 12, "K2": 12, "K3": 12}
    near = record(flip_gap=5e-6)
    assert near["faults"] == [] and near["moe"]["flip_count"] == 1
    flip = near["moe"]["flips"][0]
    assert (flip["step"], flip["layer"], flip["token"]) == (1, 3, 1)
    assert flip["gate_gap"] == pytest.approx(5e-6)
    wide = record(flip_gap=1e-3)
    assert any("routing flips" in f for f in wide["faults"])
    assert wide["moe"]["flips"][0]["after"] is None
    # in sequences of 8 tokens: the same flip after a flip at an earlier
    # layer of its own sequence follows it; after one in another
    # sequence, or at a later layer, it still fails
    monkey = pytest.MonkeyPatch()
    monkey.setattr(chip_smoke, "TRAIN_SEQ", 8)
    try:
        same = record(flip_gap=1e-3, earlier=(1, 6))
        cross = record(flip_gap=1e-3, earlier=(1, 9))
        late = record(flip_gap=1e-3, earlier=(5, 6))
    finally:
        monkey.undo()
    assert same["faults"] == [] and same["moe"]["own_flip_count"] == 1
    assert same["moe"]["flips"][1]["after"] == [1, 6]
    assert any("routing flips" in f for f in cross["faults"])
    assert any("routing flips" in f for f in late["faults"])
    bal = record(balance=(0.48, 0.47 * 4))
    assert any("balance losses" in f for f in bal["faults"])
    whole = record(split=1)
    assert any("expert weights" in f for f in whole["faults"])


def test_dropped_share_counts_pairs_past_capacity():
    """Capacity ceil(2 * 2 * 16 / 8) = 8 per expert: 32 pairs all on
    expert 0 drop 24 of them per layer."""
    ids = np.zeros((3, 16, 2), np.int16)
    assert chip_smoke.dropped_share(ids) == 24 / 32
    ids[:] = np.arange(32).reshape(16, 2) % 8
    assert chip_smoke.dropped_share(ids) == 0.0


def test_capture_and_fusion_phases_run_before_the_search():
    """The capture and fusion phases parse as --phases entries, follow
    the one-card phases and precede the search; the capture phase's
    paths and the kernels each must launch per step are the train,
    resnet and vit phases'."""
    phases = chip_smoke.ALL_PHASES.split(",")
    assert phases[22:24] == ["capture", "fusion"]
    assert "`--phases capture`" in chip_smoke.__doc__
    assert chip_smoke.CAPTURE_KERNELS == {
        "bert": {"K1": 12, "K2": 12, "K3": 12}, "resnet50": {"P1": 53},
        "vit_b16": {}}
    assert set(chip_smoke.KERNEL_TAGS) == {"K1", "K2", "K3", "K4", "P1"}
    assert chip_smoke.CAPTURE_STEPS == 3
    assert set(chip_smoke.CAPTURE_LEGS) == {"dp_tp", "dp_zero3",
                                            "slices2_dp4", "dp_zero2"}
    with pytest.raises(SystemExit):
        chip_smoke.main(["--phases", "capture,nothing"])


class _Ex:
    def __init__(self, **status):
        self.capture_status = status


class _FF:
    def __init__(self, **status):
        self.executor = _Ex(**status)


def test_counted_steps_under_capture():
    """Every step of an eager step function counts; of a captured one
    the warm-up steps and the capture, not the replays."""
    eager = _FF(mode="eager", blockers=["the cpu device"])
    assert chip_smoke.counted_steps(eager, chip_smoke.capture_counts(eager),
                                    4) == 4
    ff = _FF(mode="graph", blockers=[], warmup_steps=1, captures=0,
             replays=0)
    before = chip_smoke.capture_counts(ff)
    ff.executor.capture_status.update(captures=1, replays=3)
    assert chip_smoke.counted_steps(ff, before, 4) == 1
    before = chip_smoke.capture_counts(_FF(mode="graph", blockers=[]))
    assert before == {"warmup_steps": 0, "captures": 0, "replays": 0}
    assert chip_smoke.counted_steps(ff, before, 5) == 2


def test_gather_overlap_counts_the_gathers_beside_compute():
    """Two all-gathers of 10 us, one half under a GEMM, one alone: 20 us,
    5 beside compute; copies and other NCCL kernels are no compute."""
    events = [_Evt(0, 10, "ncclDevKernel_AllGather_RING_LL(x)"),
              _Evt(5, 30, "sm90_gemm"),
              _Evt(40, 50, "ncclDevKernel_AllGather_RING_LL(x)"),
              _Evt(40, 50, "Memcpy DtoD"),
              _Evt(40, 50, "ncclDevKernel_ReduceScatter_Sum(x)")]
    got = chip_smoke.gather_overlap(events, steps=1)
    assert got["ms_per_step"] == pytest.approx(0.02)
    assert got["beside_compute_ms_per_step"] == pytest.approx(0.005)
    assert got["beside_compute_share"] == pytest.approx(0.25)


def _capture_report(rank, mode="graph", k=12, loss=7.26, weights=0.0):
    rep = _rank_report(rank)
    rep["capture_status"] = {"mode": "graph", "blockers": []}
    rep["grad_bytes"] = {"peak": 100, "after_backward": 90, "full": 400}
    # the device's reading: stage 0 holds 310 bytes more than stage 2
    rep["grad_memory"] = {"after_backward": 1000, "peak": 5000}
    rep["zero0"] = {"losses": rep["losses"], "weights_diff": 0.0,
                    "grad_memory": {"after_backward": 1310, "peak": 5300}}
    prof = {"launches_per_step": {"K1": k, "K2": k, "K3": k, "K4": 0,
                                  "P1": 0}, "step_ms": 100.0}
    rep["capture"] = {
        "eager": {"losses": [0.69, 7.26, 5.0], "profile": prof},
        "graph": {"losses": [0.69, loss, 5.0], "profile": prof,
                  "capture_status": {"mode": mode}},
        "loss_err": abs(loss - 7.26) / 7.26, "weights_diff": weights,
        "worst_weight": "w"}
    return rep


def test_multigpu_record_checks_the_captured_legs():
    """A capture leg faults when a rank did not capture, when a replay
    launched other than K1-K3 12 times per step, or when the captured
    run left the eager one; ZeRO-2 faults when the device bytes a rank
    held after the backward exceed its shards by more than
    ZERO2_MEMORY_TOL, or fall short of ZeRO-0's by less than the whole
    grads less the shards (less that limit), as when the whole grads
    are kept."""
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}
    ref = {"losses": [0.69, 7.2601], "step_s": [1.0, 0.3],
           "last_step_moves": {"w": 1e-3, "b": 5e-5}}

    def record(name, reports):
        # (the simulator's price, which needs the card, is read for
        # NCCL records only; the capture checks read the reports alone)
        return chip_smoke._multigpu_record(legs[name], reports, ref, "gloo",
                                           4, 50.0, "", {})

    ok = record("dp_zero2", [_capture_report(r) for r in range(4)])
    assert ok["faults"] == [] and ok["capture"]["loss_err"] == 0
    assert ok["capture_status"]["mode"] == "graph"
    assert len(ok["capture"]["profile_per_rank"]) == 4
    assert ok["grad_bytes_per_rank"][0]["peak"] == 100
    assert ok["grad_memory_per_rank"][3] == {
        "zero0": {"after_backward": 1310, "peak": 5300},
        "zero2": {"after_backward": 1000, "peak": 5000}}
    eager = record("dp_tp", [_capture_report(r, mode="eager")
                             for r in range(4)])
    assert sum("did not capture" in f for f in eager["faults"]) == 4
    k = record("dp_tp", [_capture_report(r, k=11) for r in range(4)])
    assert sum("replays launched" in f for f in k["faults"]) == 4
    off = record("dp_tp", [_capture_report(r, loss=7.3) for r in range(4)])
    assert any("captured against eager" in f for f in off["faults"])
    fat = [_capture_report(r) for r in range(4)]
    from flexflow_tpu_torch.parallel.zero import BUCKET_BYTES

    # rank 2 kept its whole grads: no fewer bytes than ZeRO-0
    fat[2]["grad_bytes"] = {"peak": 4 * BUCKET_BYTES,
                            "after_backward": 100,
                            "full": 100 + 8 * BUCKET_BYTES}
    fat[2]["grad_memory"] = {"after_backward": 9 * BUCKET_BYTES}
    fat[2]["zero0"]["grad_memory"] = {"after_backward": 9 * BUCKET_BYTES}
    got = record("dp_zero2", fat)["faults"]
    assert len(got) == 2 and all("rank 2 held" in f for f in got)
    assert "beyond its grad shards" in got[0]
    assert "held 0 bytes fewer than ZeRO-0" in got[1]


def test_kernel_line_carries_the_replayed_launches():
    """K1-K3's rows carry the capture phase's launches per replayed
    BERT step (the profiler's count), None without the phase."""
    flash_main = {"kernel_ms": {k: 1.0 for k in ("K1", "K2", "K3")},
                  "plain_ms": {k: 2.0 for k in ("K1", "K2", "K3")},
                  "library_ms": {k: 1.5 for k in ("K1", "K2", "K3")},
                  "share_of_bound": {k: 0.3 for k in ("K1", "K2", "K3")},
                  "bounds": chip_smoke.flash_bounds(*SHAPE)}
    flash = {"main": {"float32": flash_main, "bfloat16": flash_main},
             "worst": {k: {"float32": (1e-6, 1e-7)}
                       for k in ("K1", "K2", "K3")}}
    kern = {"worst": {"float32": 1e-6}, "kernel_ms": 0.02, "event_ms": 0.03,
            "plain_ms": 0.3, "bound_ms": 0.01, "bound_by": "bytes",
            "share_of_bound": 0.4, "library_ms": 0.2, "split_pages": 8,
            "grid": [1, 1, 1]}
    capture = {"paths": [{"path": "bert", "graph": {"profile": {
        "launches_per_step": {"K1": 12.0, "K2": 12.0, "K3": 12.0}}}}]}
    rows = chip_smoke.kernel_line(kern, flash, None, None, None, None,
                                  "card", capture=capture)["kernels"]
    got = {r["id"]: r.get("launches_per_replayed_train_step") for r in rows}
    assert got == {"K4": None, "K1": 12.0, "K2": 12.0, "K3": 12.0}
    rows = chip_smoke.kernel_line(kern, flash, None, None, None, None,
                                  "card")["kernels"]
    assert all(r.get("launches_per_replayed_train_step") is None
               for r in rows)


def test_profile_steps_counts_device_work_only(monkeypatch):
    """The step profile's device busy is the union of the kernels' and
    copies' spans: the schedule's ProfilerStep annotations and other
    user annotations on the device timeline, which span each step's
    gaps too, are left out; kinds and launches follow the kernels'
    names."""
    import types

    import torch.profiler

    class Profile:
        def __init__(self, activities, schedule, on_trace_ready):
            self.ready, self.steps = on_trace_ready, 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def step(self):
            self.steps += 1
            if self.steps == 1 + 3:  # the warm-up, then 3 active steps
                self.ready(self)

        def events(self):
            evts = [_Evt(0, 10, "flash_fwd_kernel<float>"),
                    _Evt(20, 30, "sm90_xmma_gemm"),
                    _Evt(25, 32, "Memcpy DtoD (Device -> Device)"),
                    _Evt(0, 90, "ProfilerStep#1"),
                    _Evt(0, 90, "ffop::linear")]
            evts[-1].is_user_annotation = True
            for e in evts:
                e.device_type = "DeviceType.CUDA"
            return evts

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.profiler, "schedule", lambda **kw: kw)
    fake = types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None))
    calls = []
    rec = chip_smoke.profile_steps(fake, lambda: calls.append(1), 3)
    assert len(calls) == 4  # the dropped warm-up step and the window's 3
    assert rec["device_busy_ms"] == pytest.approx(0.022 / 3)
    assert rec["device_events_per_step"] == pytest.approx(1.0)
    assert rec["launches_per_step"]["K1"] == pytest.approx(1 / 3)
    assert rec["device_ms_by_kind"]["gemm"] == pytest.approx(0.01 / 3)
    assert rec["device_ms_by_kind"]["copies"] == pytest.approx(0.007 / 3)
    assert rec["attempts"] == 1


def test_store_phase_follows_the_search():
    phases = chip_smoke.ALL_PHASES.split(",")
    assert phases.index("store") == phases.index("search") + 1
    assert "`--phases store`" in chip_smoke.__doc__
    assert (chip_smoke.STORE_STEPS, chip_smoke.STORE_PROFILE_STEPS) == (2, 2)


def test_store_catalog_parses_equal_and_verifies(tmp_path, monkeypatch):
    """The catalog's JSON and wire forms parse to the same rules, every
    rule verifies exact, and the parallel rules are instantiated at each
    of the search's degrees; on a small BERT the linear and add rules
    match (ffn2 and the classifier, both residual adds per layer), the
    relu-concat hoist does not."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.transformer import build_bert
    from flexflow_tpu_torch.pcg.rewrite import CATALOG_DEGREES
    from flexflow_tpu_torch.pcg.taso import load_taso_rules

    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE_DIR", str(tmp_path / "c"))
    cat = chip_smoke.write_store_catalog(str(tmp_path))
    assert cat["rules"] == 3
    assert set(cat["verdicts"].values()) == {"exact"}
    assert cat["report"] == {"converted": 3,
                             "instantiated": 2 * len(CATALOG_DEGREES) + 1}
    assert Path(cat["pb"]).read_bytes()[:1] == b"\x0a"
    ff = FFModel(FFConfig(batch_size=8, device="cpu"))
    build_bert(ff, batch_size=8, seq_length=16, hidden_size=32, num_layers=2,
               num_heads=4, intermediate_size=64)
    rules = {r.name: r for r in load_taso_rules(cat["pb"], degrees=(2,))[0]}
    assert len(rules["taso_rule_0@2"].find_matches(ff.layers)) == 3
    assert len(rules["taso_rule_1@2"].find_matches(ff.layers)) == 4
    assert rules["taso_rule_2@2"].find_matches(ff.layers) == []


def test_kernel_cache_check(tmp_path):
    lib = tmp_path / "kernel_cache" / "libff_flash_attention_0.so"
    lib.parent.mkdir()
    lib.write_bytes(b"")
    good = [{"nvcc_runs": 1, "library": str(lib), "k1_launches": 1},
            {"nvcc_runs": 0, "library": str(lib), "k1_launches": 1}]
    assert chip_smoke.kernel_cache_faults(str(tmp_path), good) == []
    rebuilt = [good[0], dict(good[1], nvcc_runs=1)]
    assert "nvcc ran 1 and 1" in chip_smoke.kernel_cache_faults(
        str(tmp_path), rebuilt)[0]
    elsewhere = [dict(g, library="/other/lib.so") for g in good]
    assert "not under" in chip_smoke.kernel_cache_faults(
        str(tmp_path), elsewhere)[0]
    idle = [good[0], dict(good[1], k1_launches=0)]
    assert chip_smoke.kernel_cache_faults(str(tmp_path), idle) == [
        "a child launched no K1"]


def test_kernel_line_carries_the_store_launches():
    flash_main = {"kernel_ms": {k: 1.0 for k in ("K1", "K2", "K3")},
                  "plain_ms": {k: 2.0 for k in ("K1", "K2", "K3")},
                  "library_ms": {k: 1.5 for k in ("K1", "K2", "K3")},
                  "share_of_bound": {k: 0.3 for k in ("K1", "K2", "K3")},
                  "bounds": chip_smoke.flash_bounds(*SHAPE)}
    flash = {"main": {"float32": flash_main, "bfloat16": flash_main},
             "worst": {k: {"float32": (1e-6, 1e-7)}
                       for k in ("K1", "K2", "K3")}}
    kern = {"worst": {"float32": 1e-6}, "kernel_ms": 0.02, "event_ms": 0.03,
            "plain_ms": 0.3, "bound_ms": 0.01, "bound_by": "bytes",
            "share_of_bound": 0.4, "library_ms": 0.2, "split_pages": 8,
            "grid": [1, 1, 1]}
    per_step = {"K1": 12.0, "K2": 12.0, "K3": 12.0, "K4": 0.0, "P1": 0.0}
    store = {"flash_launches": {"K1": 70, "K2": 48, "K3": 48},
             "train": {"profile": {"restored": {
                 "launches_per_step": per_step}}}}
    rows = chip_smoke.kernel_line(kern, flash, None, None, None, None,
                                  "card", store=store)["kernels"]
    got = {r["id"]: (r.get("launches_store"),
                     r.get("launches_per_replayed_store_step"))
           for r in rows}
    assert got == {"K4": (None, None), "K1": (70, 12.0), "K2": (48, 12.0),
                   "K3": (48, 12.0)}


def test_ckpt_reshard_leg_follows_the_issue():
    """The last leg before the supervisor's two: data 4 at ZeRO-2 under
    Adam (dp_zero2's model and reference) that saves with both managers
    after its first step and is restored onto 2 ranks at ZeRO-1 and onto
    one card; it leaves the ladder's own checks (ZeRO-0 beside it, grad
    memory) to dp_zero2."""
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}
    leg = chip_smoke.MULTIGPU_LEGS[-4]
    assert leg["name"] == "ckpt_reshard" and leg["checkpoint"] is True
    assert {k: v for k, v in leg.items() if k not in ("name", "checkpoint")} \
        == {k: v for k, v in legs["dp_zero2"].items() if k != "name"}
    assert chip_smoke.CKPT_RESHARD_TARGETS == ((2, 1), (1, 0))
    assert chip_smoke.CKPT_KINDS == ("local", "dcp")
    assert chip_smoke._ladder(leg) is None
    assert chip_smoke._ladder(legs["dp_zero2"]) == 2
    assert chip_smoke._ladder(legs["dp_tp"]) is None


def test_resilience_phase_bookkeeping():
    """The resilience phase's host-side helpers: state_diff over every
    leaf (a missing leaf raises), the tracer's span durations per
    thread, and the phase's place before supervised and multigpu."""
    a = {"w": np.zeros((2, 3), np.float32), "t": np.array(3, np.int32)}
    b = {"w": np.full((2, 3), 0.5, np.float32), "t": np.array(3, np.int32)}
    assert chip_smoke.state_diff(a, a) == 0.0
    assert chip_smoke.state_diff(a, b) == 0.5
    with pytest.raises(RuntimeError, match="leaves differ"):
        chip_smoke.state_diff(a, {"w": a["w"]})
    events = [{"name": "flush", "ph": "B", "ts": 0.0, "tid": 1},
              {"name": "flush", "ph": "B", "ts": 500.0, "tid": 2},
              {"name": "flush", "ph": "E", "ts": 2000.0, "tid": 1},
              {"name": "snapshot", "ph": "B", "ts": 0.0, "tid": 1},
              {"name": "flush", "ph": "E", "ts": 1500.0, "tid": 2}]
    assert chip_smoke._span_ms(events, "flush") == [2.0, 1.0]
    phases = chip_smoke.ALL_PHASES.split(",")
    assert phases.index("resilience") == phases.index("multigpu") - 3
    assert chip_smoke.RES_HANG_S > chip_smoke.RES_STEP_TIMEOUT


def test_resilience_window_and_overhead_bookkeeping(monkeypatch):
    """replay_attribution counts a flash kernel as replayed only under a
    cudaGraphLaunch's correlation and as attributed only with an attn_*
    op; overhead_fits alternates off, on, on, off and times both sides
    by the same fit wall."""
    tags = chip_smoke.KERNEL_TAGS
    chrome = [{"cat": "cuda_runtime", "name": "cudaGraphLaunch",
               "args": {"correlation": 3}},
              {"cat": "kernel", "name": tags["K1"],
               "args": {"correlation": 3, "op": "attn_0"}},
              {"cat": "kernel", "name": tags["K2"],
               "args": {"correlation": 3, "op": "dense_1"}},
              {"cat": "kernel", "name": tags["K3"],
               "args": {"correlation": 4}}]
    got = chip_smoke.replay_attribution(chrome)
    assert got == {"K1": {"launches": 1, "replayed": 1, "in_attn": 1},
                   "K2": {"launches": 1, "replayed": 1, "in_attn": 0},
                   "K3": {"launches": 1, "replayed": 0, "in_attn": 0}}
    ops = [(tags["K1"], "attn_0"), ("gemm", "dense_1"), ("add", None)]
    chrome[0]["ts"] = 0
    for i, e in enumerate(chrome[1:]):
        e["ts"] = i + 1
    chrome.insert(3, {"cat": "kernel", "name": "gemm", "ts": 1.5,
                      "args": {"correlation": 3}})
    summary = chip_smoke.kernel_map_summary(chrome, ops)
    assert summary == {"len": 3, "replay_len": 3,
                       "flash": {"K1": 1, "K2": 0, "K3": 0},
                       "first_difference": 2, "map_there": ["add"],
                       "replay_there": [tags["K2"]]}
    order = []
    walls = {"off": iter([1.0, 1.2, 1.1, 1.3]),
             "on": iter([1.1, 1.1, 1.2, 1.2])}

    def timed(torch, ff, x, y, callbacks=()):
        order.append(ff)
        (clock,) = callbacks
        clock.at = [0.0, 0.25, 0.5] if ff == "off" else [0.0, 0.3, 0.6]
        return next(walls[ff])

    monkeypatch.setattr(chip_smoke, "_timed_fit", timed)
    monkeypatch.setattr(chip_smoke, "RES_OVH_ROUNDS", 2)
    y = np.zeros(chip_smoke.TRAIN_BATCH * 4)
    ovh = chip_smoke.overhead_fits(None, {"off": "off", "on": "on"}, None, y)
    assert order == ["off", "on", "on", "off"] * 2
    assert ovh["steps_per_fit"] == 4 and ovh["fits_per_side"] == 4
    walls = ovh["fit_wall_per_step"]
    assert walls["median_ms"] == pytest.approx({"off": 1.15e3 / 4,
                                                "on": 1.15e3 / 4})
    assert walls["overhead"] == pytest.approx(0.0)
    assert walls["spread"]["off"] == pytest.approx(0.3 / 1.15)
    assert ovh["fit_extra_ms"] == pytest.approx(0.0)
    gaps = ovh["step_gap"]
    assert gaps["median_ms"] == pytest.approx({"off": 250.0, "on": 300.0})
    assert gaps["overhead"] == pytest.approx(0.2)
    assert gaps["spread"] == pytest.approx({"off": 0.0, "on": 0.0})


# -- the supervised phase and legs ------------------------------------------

def test_supervised_phase_and_legs_follow_their_plan():
    """`supervised` runs after resilience and before multigpu: BERT-base
    through fit_resilient for 10 steps, a checkpoint every 4 (async, a
    file:// remote tier), nan_policy restore and a 2 s watchdog, under a
    seeded plan of one STEP_EXCEPTION, one NAN_LOSS and one HUNG_STEP at
    distinct steps and a remote CHECKPOINT_WRITE before the last save;
    SIGTERM at step 5.  The elastic leg: 4 ranks, data 4 under Adam, a
    checkpoint every 2, 2 survivors at step 3, run to step 6, held to
    MULTIGPU_TOL (3e-4 for Adam's weights); preempt_barrier: 4 ranks,
    ranks 0-2 signalled during step 1 and rank 3 during step 2, so the
    agreed and saved step is 3."""
    from flexflow_tpu_torch.resilience import FaultKind

    phases = chip_smoke.ALL_PHASES.split(",")
    assert phases.index("supervised") == phases.index("resilience") + 1
    # (the tools phase reads what it wrote, before multigpu)
    assert phases.index("supervised") == phases.index("multigpu") - 2
    assert "`--phases\nsupervised`" in chip_smoke.__doc__
    assert "elastic,preempt_barrier" in chip_smoke.__doc__
    assert (chip_smoke.SUP_STEPS, chip_smoke.SUP_EVERY) == (10, 4)
    assert chip_smoke.SUP_STEP_TIMEOUT == 2.0
    assert chip_smoke.SUP_SIGTERM_STEP == 5
    plan = chip_smoke.supervised_plan()
    assert [(f.step, f.kind, f.payload) for f in plan.faults] == [
        (3, FaultKind.HUNG_STEP, {}), (4, FaultKind.NAN_LOSS, {}),
        (5, FaultKind.STEP_EXCEPTION, {}),
        (plan.faults[3].step, FaultKind.CHECKPOINT_WRITE,
         {"target": "remote"})]
    assert 1 <= plan.faults[3].step <= 8
    assert plan.to_json() == chip_smoke.supervised_plan().to_json()
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}
    assert [leg["name"] for leg in chip_smoke.MULTIGPU_LEGS][-3:-1] == [
        "elastic", "preempt_barrier"]
    assert legs["elastic"] == {"name": "elastic", "ranks": 4,
                               "strategy": ["dp"], "optimizer": "adam",
                               "supervised": "elastic"}
    assert legs["preempt_barrier"]["ranks"] == 4
    assert (chip_smoke.ELASTIC_STEPS, chip_smoke.ELASTIC_EVERY,
            chip_smoke.ELASTIC_LOSS_STEP, chip_smoke.ELASTIC_SURVIVORS) == \
        (6, 2, 3, 2)
    assert chip_smoke.MULTIGPU_TOL["adam_weights"] == 3e-4
    assert chip_smoke.BARRIER_SIGNAL_STEP == 1
    with pytest.raises(SystemExit):
        chip_smoke.main(["--phases", "supervised,nothing"])
    with pytest.raises(SystemExit):
        chip_smoke.main(["--legs", "elastic,nothing"])


def test_kernel_line_carries_the_supervised_launches():
    flash_main = {"kernel_ms": {k: 1.0 for k in ("K1", "K2", "K3")},
                  "plain_ms": {k: 2.0 for k in ("K1", "K2", "K3")},
                  "library_ms": {k: 1.5 for k in ("K1", "K2", "K3")},
                  "share_of_bound": {k: 0.3 for k in ("K1", "K2", "K3")},
                  "bounds": chip_smoke.flash_bounds(*SHAPE)}
    flash = {"main": {"float32": flash_main, "bfloat16": flash_main},
             "worst": {k: {"float32": (1e-6, 1e-7)}
                       for k in ("K1", "K2", "K3")}}
    kern = {"worst": {"float32": 1e-6}, "kernel_ms": 0.02, "event_ms": 0.03,
            "plain_ms": 0.3, "bound_ms": 0.01, "bound_by": "bytes",
            "share_of_bound": 0.4, "library_ms": 0.2, "split_pages": 8,
            "grid": [1, 1, 1]}
    supervised = {"faulted": {
        "launches": {"K1": 48, "K2": 48, "K3": 48},
        "launches_per_replayed_step": {"K1": 12.0, "K2": 12.0, "K3": 12.0}}}
    legs = {"legs": [{"leg": "elastic", "launches_per_rank_per_step": [
        {"K1": 12.0, "K2": 12.0, "K3": 12.0, "P1": 0.0}] * 2}]}
    rows = chip_smoke.kernel_line(kern, flash, None, None, None, None,
                                  "card", multigpu=legs,
                                  supervised=supervised)["kernels"]
    got = {r["id"]: (r.get("launches_supervised"),
                     r.get("launches_per_replayed_step_supervised"),
                     (r.get("launches_multigpu_per_rank_per_step")
                      or {}).get("elastic"))
           for r in rows}
    assert got == {"K4": (None, None, None),
                   "K1": (48, 12.0, [12.0, 12.0]),
                   "K2": (48, 12.0, [12.0, 12.0]),
                   "K3": (48, 12.0, [12.0, 12.0])}
    rows = chip_smoke.kernel_line(kern, flash, None, None, None, None,
                                  "card")["kernels"]
    assert all(r.get("launches_supervised") is None for r in rows)


def test_dropping_the_cache_op_rewires_its_consumers():
    """The supervised phase's alter hook: the layer graph without its
    Cache op, the op's consumer reading its input, and the model
    recompiled from it with no Cache op left."""
    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=8, device="cpu"))
    x = ff.create_tensor([8, 16], name="input")
    t = ff.cache(x, 2, name="input_cache")
    t = ff.dense(t, 4, name="head")
    ff.softmax(t)
    ff.compile(seed=0)
    assert [op.name for op in ff._cache_ops] == ["input_cache"]
    assert chip_smoke._drop_cache_op(ff) == "input_cache"
    head = next(op for op in ff.layers.ops if op.name == "head")
    assert head.inputs[0] is x
    ff.recompile()
    assert ff._cache_ops == []
    assert not any("cache" in b for b in
                   ff.executor.capture_status["blockers"])


def test_the_last_line_is_unchanged():
    """main ends with the card line, then the unchanged last line."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    tail = src[src.rindex("print(card, flush=True)"):]
    assert tail.split() == """print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0""".split()


def test_only_the_group_of_4_runs_the_supervised_legs(monkeypatch):
    """The supervised legs' bodies go to the group of 4 the multigpu
    phase spawns for its legs, and to no other group that phase hands
    its job to (ckpt_reshard's restore onto 2 ranks among them)."""
    from types import SimpleNamespace

    jobs = []

    def run_ranks(world, cards, job, out_dir):
        jobs.append((world, [leg["name"] for leg in job["legs"]],
                     list(job.get("supervised", ()))))
        outs = [{"legs": [{} for _ in job["legs"]], "barrier": {},
                 "elastic": {}} for _ in range(world)]
        return "gloo", 1.0, outs

    monkeypatch.setattr(chip_smoke, "_run_ranks", run_ranks)
    monkeypatch.setattr(chip_smoke, "_one_card_reference",
                        lambda torch, name, tmp: ({"losses": [1.0, 1.0]},
                                                  "x", "y"))
    monkeypatch.setattr(chip_smoke, "_multigpu_record",
                        lambda leg, *a: {"leg": leg["name"], "faults": []})
    monkeypatch.setattr(chip_smoke, "_restored_second_step",
                        lambda *a: {})
    for name in ("_elastic_record", "_barrier_record"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda ranks, out_dir: {"faults": []})
    monkeypatch.setattr(chip_smoke, "np", SimpleNamespace(
        load=lambda path: {"x": None, "y": None}))
    torch = SimpleNamespace(cuda=SimpleNamespace(device_count=lambda: 1))
    rec = chip_smoke.phase_multigpu(
        torch, None, "card", "/tmp",
        {"ckpt_reshard", "elastic", "preempt_barrier"})
    assert jobs == [(4, ["ckpt_reshard"], ["barrier", "elastic"]),
                    (2, ["ckpt_restore_2"], [])]
    assert [leg["leg"] for leg in rec["legs"]] == [
        "ckpt_reshard", "elastic", "preempt_barrier"]


# -- the tools phase and the keras_devices leg ------------------------------------

def test_tools_phase_reads_what_the_phases_before_it_wrote():
    """`tools` runs after supervised and before multigpu, and only with
    the three phases whose files it reads."""
    phases = chip_smoke.ALL_PHASES.split(",")
    assert phases.index("tools") == phases.index("supervised") + 1
    assert phases.index("tools") == phases.index("multigpu") - 1
    assert chip_smoke.TOOLS_INPUTS == ("store", "resilience", "supervised")
    assert (chip_smoke.TOOLS_JOB, chip_smoke.TOOLS_DEVICES) == (
        "bert_encoder", 8)
    assert "--phases store,resilience,supervised,tools" in \
        chip_smoke.__doc__.replace("\n", " ")
    for argv in (["--phases", "tools"], ["--phases", "store,tools"]):
        with pytest.raises(SystemExit):
            chip_smoke.main(argv)


def test_tools_phase_parses_the_summary_and_flips_a_leaf(tmp_path):
    """summary_rows reads telemetry_summary's table (titles underlined,
    rows `name  value`); hist_row is its histogram row; flip_leaf_byte
    flips one byte of the largest leaf's data, which np.load and the
    fsck then refuse."""
    from flexflow_tpu_torch.obs.metrics import MetricsRegistry
    from flexflow_tpu_torch.tools import checkpoint_fsck, telemetry_summary

    reg = MetricsRegistry()
    for v in (10.0, 12.5, 11.0):
        reg.histogram("fit/step_ms").observe(v)
    reg.histogram("resilience/offload_upload_ms").observe(4321.123)
    reg.counter("resilience/restarts").inc(3)
    text = telemetry_summary.summarize(reg.drain())
    rows = chip_smoke.summary_rows(text)
    assert rows["Steps"] == {"steps": "3", "dispatch ms mean": "11.17",
                             "dispatch ms min/max": "10 / 12.5"}
    assert rows["Resilience"] == {"restarts": "3"}
    h = reg.histogram("resilience/offload_upload_ms")
    assert rows["Durability"]["offload_upload_ms"] == chip_smoke.hist_row(
        {"count": h.count, "mean": h.mean, "min": h.min, "max": h.max}) == \
        "n=1 mean=4321 min=4321 max=4321"

    step = tmp_path / "ckpt" / "step_00000003"
    step.mkdir(parents=True)
    leaves = {"['weights']['a']['kernel']": np.arange(4096, dtype=np.float32),
              "['rng']": np.zeros(16, np.uint8)}
    np.savez(step / "state.npz", **leaves)
    from flexflow_tpu_torch.checkpoint import _build_manifest

    (step / "manifest.json").write_text(json.dumps(_build_manifest(
        3, leaves)))
    (step / "meta.json").write_text(json.dumps({"step": 3}))
    (tmp_path / "ckpt" / "LATEST").write_text("3")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert checkpoint_fsck.main([str(tmp_path / "ckpt")]) == 0
    assert chip_smoke.flip_leaf_byte(str(step / "state.npz")) == \
        "['weights']['a']['kernel']"
    with contextlib.redirect_stdout(out):
        assert checkpoint_fsck.main([str(tmp_path / "ckpt")]) == 1
    assert "step        3  CORRUPT" in out.getvalue()


def _tools_inputs(root):
    """What the store, resilience and supervised phases keep for the
    tools phase, made on the host at a small size: the catalog, a traced
    fit's trace_dir and a DCP step, and a supervised run's trace_dir,
    checkpoint directory and remote tier; the two histograms the phase
    records."""
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer
    from flexflow_tpu_torch.checkpoint import (CheckpointManager,
                                               LocalCheckpointManager)
    from flexflow_tpu_torch.fftype import ActiMode
    from flexflow_tpu_torch.obs.metrics import registry_of
    from flexflow_tpu_torch.resilience import offload, supervisor
    from flexflow_tpu_torch.store.blobstore import LocalBlobStore

    (root / "store").mkdir(parents=True)
    chip_smoke.write_store_catalog(str(root / "store"))

    def model(trace):
        ff = FFModel(FFConfig(batch_size=16, device="cpu",
                              trace_dir=str(trace)))
        x = ff.create_tensor([16, 8], name="x")
        ff.softmax(ff.dense(ff.dense(x, 16, activation=ActiMode.RELU), 4))
        ff.compile(optimizer=SGDOptimizer(lr=0.05), seed=0)
        return ff

    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = rng.randint(0, 4, 64).astype(np.int32)
    ff = model(root / "resilience" / "trace")
    ff.fit(x, y, epochs=1, verbose=False,
           callbacks=[chip_smoke_checkpoint(root / "resilience" / "local")])
    ff.telemetry.flush()
    h = ff.telemetry.metrics.histogram("fit/step_ms")
    step_ms = {"count": h.count, "mean": h.mean, "min": h.min, "max": h.max}
    CheckpointManager(str(root / "resilience" / "dcp")).save(ff, 4)
    sup = root / "supervised"
    ff = model(sup / "trace_fault")
    off = offload.CheckpointOffloader(
        offload.RemoteCheckpointStore(LocalBlobStore(
            str(sup / "remote_fault"))), registry=registry_of(ff),
        sleep=lambda s: None)
    supervisor.TrainingSupervisor(ff, str(sup / "fault"), checkpoint_every=2,
                                  offloader=off, sleep=lambda s: None).run(
                                      x, y, num_steps=4)
    h = registry_of(ff).histogram("resilience/offload_upload_ms")
    upload_ms = {"count": h.count, "mean": h.mean, "min": h.min,
                 "max": h.max}
    assert LocalCheckpointManager(str(sup / "fault")).all_steps()
    return step_ms, upload_ms


def chip_smoke_checkpoint(directory):
    from flexflow_tpu_torch.checkpoint import ModelCheckpoint

    return ModelCheckpoint(str(directory), every_steps=2, local=True)


def test_tools_phase_on_the_host(tmp_path, monkeypatch, capsys):
    """phase_tools end to end over small host-made inputs (device
    "cpu"): every tool's exit code, the summaries' Steps and Durability
    rows equal to the runs' own histograms, the flipped copy's step
    named, the store hit returning the shipped strategy, no launch; a
    summary whose mean differs is a fault."""
    monkeypatch.setenv("FLEXFLOW_TPU_TORCH_CACHE_DIR", str(tmp_path / "c"))
    step_ms, upload_ms = _tools_inputs(tmp_path / "kept")
    assert upload_ms["count"] >= 1
    rec = chip_smoke.phase_tools(None, "card", str(tmp_path / "kept"),
                                 step_ms, upload_ms, device="cpu")
    assert rec["faults"] == []
    assert {c: t["rc"] for c, t in rec["tools"].items()} == {
        "summary_resilience": 0, "summary_supervised": 0, "summary_cli": 0,
        "fsck_clean": 0, "fsck_flipped": 1, "fsck_dangling": 1,
        "fsck_dcp": 0, "store_import": 0, "pb_to_json": 0,
        "metric_docs": 0}
    assert rec["checks"]["store_hit"]["store_hit"] is True
    assert rec["checks"]["store_hit"]["shipped"] is True
    assert rec["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "P1": 0}
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["case"] for ln in lines if "case" in ln] == list(rec["tools"])
    bad = dict(step_ms, mean=step_ms["mean"] + 1.0)
    with pytest.raises(RuntimeError, match="fit/step_ms"):
        chip_smoke.phase_tools(None, "card", str(tmp_path / "kept"), bad,
                               upload_ms, device="cpu")


def test_keras_devices_leg_follows_its_plan(tmp_path):
    """The leg: 4 ranks in a group of their own, the Keras MLP example
    (seq_mnist_mlp, Adam) compiled with devices=[0, 1] over 4 batches;
    its job's batches and weights; its record holds ranks 2-3 to leaving
    and ranks 0-1 to the 2-card run within MULTIGPU_TOL."""
    legs = {leg["name"]: leg for leg in chip_smoke.MULTIGPU_LEGS}
    assert legs["keras_devices"] == {"name": "keras_devices", "ranks": 4,
                                     "keras": "devices"}
    assert chip_smoke.MULTIGPU_LEGS[-1]["name"] == "keras_devices"
    assert (chip_smoke.KERAS_DEVICES_MODEL, chip_smoke.KERAS_DEVICES,
            chip_smoke.KERAS_DEVICES_STEPS) == ("seq_mnist_mlp", (0, 1), 4)
    assert "keras_devices" in chip_smoke.__doc__
    job = chip_smoke._keras_devices_job(None, str(tmp_path))
    with np.load(job["data"]) as data:
        assert data["x"].shape == (256, 784) and data["y"].shape == (256,)
    w = chip_smoke._load_flat(job["weights"])
    assert sorted(w) == ["0", "1", "2"]  # by position

    def stayed(i, loss_shift=0.0):
        run = {"losses": [2.3, 2.2, 2.1, 2.0], "world": 2, "rank": i,
               "compile_s": 1.0, "reform_s": 0.5, "step_ms": [1.0] * 4,
               "capture_mode": "graph"}
        ref = dict(run, losses=[v + loss_shift for v in run["losses"]],
                   reform_s=None)
        zeros = {k: 0 for k in ("K1", "K2", "K3", "K4", "P1")}
        return {"left": False, "devices": run, "reference": ref,
                "launches": zeros, "launches_per_step": zeros}

    left = {"left": True, "in_group": False, "compile_s": 0.4,
            "fit_error": "model: rank 2 left the torch.distributed group "
                         "of 4 when it re-formed onto ranks [0, 1]"}
    chip_smoke._save_flat(f"{tmp_path}/keras_devices_weights.npz", w)
    chip_smoke._save_flat(f"{tmp_path}/keras_reference_weights.npz", w)
    rec = chip_smoke._keras_devices_record(
        [stayed(0), stayed(1), left, dict(left)], str(tmp_path))
    assert rec["faults"] == [] and rec["left"] == [2, 3]
    assert rec["max_weight_diff"] == 0.0
    assert len(rec["launches_per_rank_per_step"]) == 2
    rec = chip_smoke._keras_devices_record(
        [stayed(0, 1.0), stayed(1), dict(left, in_group=True), left],
        str(tmp_path))
    assert len(rec["faults"]) == 2


def test_keras_devices_runs_in_a_group_of_its_own(monkeypatch, tmp_path):
    """The leg's bodies go to a group of 4 of their own, after every
    other group (they leave a group of 2), with the job's inputs."""
    from types import SimpleNamespace

    jobs = []

    def run_ranks(world, cards, job, out_dir):
        jobs.append((world, [leg["name"] for leg in job["legs"]],
                     list(job.get("supervised", ())),
                     sorted(job.get("keras_devices") or {})))
        outs = [{"legs": [{} for _ in job["legs"]], "elastic": {},
                 "keras_devices": {}} for _ in range(world)]
        return "gloo", 1.0, outs

    monkeypatch.setattr(chip_smoke, "_run_ranks", run_ranks)
    monkeypatch.setattr(chip_smoke, "_elastic_record",
                        lambda ranks, out_dir: {"faults": []})
    monkeypatch.setattr(chip_smoke, "_keras_devices_record",
                        lambda ranks, out_dir: {"faults": []})
    torch = SimpleNamespace(cuda=SimpleNamespace(device_count=lambda: 1))
    rec = chip_smoke.phase_multigpu(torch, None, "card", str(tmp_path),
                                    {"elastic", "keras_devices"})
    assert jobs == [(4, [], ["elastic"], []),
                    (4, [], [], ["data", "synthetic", "weights"])]
    assert [leg["leg"] for leg in rec["legs"]] == ["elastic",
                                                   "keras_devices"]


def test_kernel_line_carries_the_tools_launches():
    flash_main = {"kernel_ms": {k: 1.0 for k in ("K1", "K2", "K3")},
                  "plain_ms": {k: 2.0 for k in ("K1", "K2", "K3")},
                  "library_ms": {k: 1.5 for k in ("K1", "K2", "K3")},
                  "share_of_bound": {k: 0.3 for k in ("K1", "K2", "K3")},
                  "bounds": chip_smoke.flash_bounds(*SHAPE)}
    flash = {"main": {"float32": flash_main, "bfloat16": flash_main},
             "worst": {k: {"float32": (1e-6, 1e-7)}
                       for k in ("K1", "K2", "K3")}}
    kern = {"worst": {"float32": 1e-6}, "kernel_ms": 0.02, "event_ms": 0.03,
            "plain_ms": 0.3, "bound_ms": 0.01, "bound_by": "bytes",
            "share_of_bound": 0.4, "library_ms": 0.2, "split_pages": 8,
            "grid": [1, 1, 1]}
    tools = {"launches": {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "P1": 0}}
    rows = chip_smoke.kernel_line(kern, flash, None, None, None, None,
                                  "card", tools=tools)["kernels"]
    assert {r["id"]: r["launches_tools"] for r in rows} == {
        "K4": 0, "K1": 0, "K2": 0, "K3": 0}
    rows = chip_smoke.kernel_line(kern, flash, None, None, None, None,
                                  "card")["kernels"]
    assert all(r["launches_tools"] is None for r in rows)
