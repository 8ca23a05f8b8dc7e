"""chip_smoke.py's bookkeeping that runs without a card: the flash
kernels' bounds on the route each kernel takes, and the count of tensor
core instructions per kernel instance read from a SASS listing."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# BERT-base at batch 8, seq 2048: [96, 2048, 64]
SHAPE = (96, 2048, 2048, 64)


def test_flash_bounds_name_the_route_of_each_kernel():
    """float32: K1 on the SIMT path (flops at 67 TFLOP/s), K2 and K3 on
    the tensor cores in three TF32 passes (3 x flops at 495 TFLOP/s)."""
    b = chip_smoke.flash_bounds(*SHAPE)
    pairs = 96 * 2048 * 2048 * 64
    for kern, flops in (("K1", 4 * pairs), ("K2", 6 * pairs),
                        ("K3", 8 * pairs)):
        assert b[kern]["flops"] == flops
        assert b[kern]["simt_bound_ms"] == pytest.approx(flops / 67e9)
        assert b[kern]["tc_bound_ms"] == pytest.approx(3 * flops / 495e9)
    assert b["K1"]["route"] == "simt"
    assert b["K1"]["bound_ms"] == b["K1"]["simt_bound_ms"]
    assert b["K1"]["bound_by"] == "operations, float32 SIMT"
    for kern, ms in (("K2", 0.937), ("K3", 1.249)):
        assert b[kern]["route"] == "tensor_cores"
        assert b[kern]["bound_ms"] == pytest.approx(ms, abs=5e-4)
        assert b[kern]["bound_by"] == "operations, 3xTF32 tensor cores"
    assert b["K1"]["tc_bound_ms"] == pytest.approx(0.625, abs=5e-4)


def test_flash_bounds_in_bfloat16():
    """bfloat16 products take one pass at 989 TFLOP/s and move half the
    bytes (LSE and delta stay float32)."""
    b32 = chip_smoke.flash_bounds(*SHAPE)
    b16 = chip_smoke.flash_bounds(*SHAPE, "bfloat16")
    for kern in ("K2", "K3"):
        assert b16[kern]["bound_ms"] == pytest.approx(
            b16[kern]["flops"] / 989e9)
        assert b16[kern]["bound_by"] == "operations, bfloat16 tensor cores"
        assert b16[kern]["bytes"] < b32[kern]["bytes"]
    assert b16["K1"]["bound_ms"] == b32["K1"]["bound_ms"]


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN51_GLOBAL__N__0015155a_18_flash_attention_cu_1859254719flash_bwd_dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iifi
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0110*/                   HMMA.1688.F32.TF32 R4, R10, R14, R4 ;
        /*0120*/                   LDSM.16.M88.4 R8, [R2] ;
\t\tFunction : _ZN51_GLOBAL__N__0015155a_18_flash_attention_cu_1859254720flash_bwd_dkv_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iifi
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
\t\tFunction : _ZN51_GLOBAL__N__0015155a_18_flash_attention_cu_1859254716flash_fwd_kernelIfLi64EEEvPKT_S3_S3_PS1_Pfiifi
        /*0100*/                   FFMA R4, R8, R12, R4 ;
\t\tFunction : _ZN61_GLOBAL__N__paged_attention_kernelIfLi64EEEvPKfS1_S1_PKiS3_Pfiiiif
        /*0100*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
"""


def test_count_sass_per_kernel_instance():
    assert chip_smoke.count_sass(SASS) == {
        "K2 float32 d64": {"hmma": 2, "instructions": 3},
        "K3 bfloat16 d128": {"hmma": 1, "instructions": 1},
        "K1 float32 d64": {"hmma": 0, "instructions": 1}}


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
