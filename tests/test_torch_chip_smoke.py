"""chip_smoke.py's bookkeeping that runs without a card: the flash
kernels' bounds on the route each kernel takes, the count of tensor
core instructions per kernel instance read from a SASS listing, the
paged-attention kernel's split grid and bytes bound, the phase list,
the ViT-B/16 op-count table and the ViT profile's kernel kinds."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
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
    assert phases[11:] == ["vit", "vit_parity", "vit_profile"]


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
