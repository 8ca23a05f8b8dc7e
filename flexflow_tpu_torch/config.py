"""Runtime configuration of the PyTorch port.

Counterpart of flexflow_tpu/config.py, cut to the FFConfig fields and
`from_args` flags the serving and training slices read: the batch size,
epochs, learning rate and weight decay, the compute dtype, the seed of
the weight init, attention's flash crossover, the paged KV-pool
geometry of the continuous engine, and `device`, which the reference
does not have.  The flag names are the reference's own.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import torch

# default of FFConfig.flash_min_seq (the reference's DEFAULT_FLASH_MIN_SEQ)
DEFAULT_FLASH_MIN_SEQ = 2048

COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    seed: int = 0
    compute_dtype: str = "float32"

    # -- training (the reference's -e, -b, --lr, --wd)
    epochs: int = 1
    learning_rate: float = 0.01
    weight_decay: float = 1e-4
    # attention takes the flash kernels at KV length >= this (or when the
    # score tensor would pass 2 GiB); 0 forces flash everywhere.  Compile
    # stamps it on every op.
    flash_min_seq: int = DEFAULT_FLASH_MIN_SEQ
    # "cuda" (the default) or "cuda:N" runs on the card and raises when
    # there is none; "cpu" runs the ops and the kernels' plain versions
    # on the host
    device: str = "cuda"

    # -- serving: paged KV pool geometry of the continuous engine
    kv_page_size: int = 16     # tokens per KV block (must divide max_seq)
    kv_pool_blocks: int = 0    # physical blocks incl. scratch; 0 = auto
    serving_slots: int = 8     # continuous decode batch slots
    prefill_chunk: int = 8     # prompt tokens per prefill dispatch
    prefix_cache: bool = True  # copy-on-write prompt-prefix sharing

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                f"got {self.compute_dtype!r}")
        try:
            dev_type = torch.device(self.device).type
        except RuntimeError:
            dev_type = None
        if dev_type not in ("cuda", "cpu"):
            raise ValueError(
                f"device must be 'cuda', 'cuda:N' or 'cpu', got "
                f"{self.device!r}")
        if self.flash_min_seq < 0:
            raise ValueError(
                f"flash_min_seq must be >= 0 (0 = always flash), got "
                f"{self.flash_min_seq}")
        if self.kv_page_size < 1:
            raise ValueError(
                f"kv_page_size must be >= 1, got {self.kv_page_size}")
        if self.kv_pool_blocks < 0:
            raise ValueError(
                f"kv_pool_blocks must be >= 0 (0 = auto), "
                f"got {self.kv_pool_blocks}")
        if self.serving_slots < 1:
            raise ValueError(
                f"serving_slots must be >= 1, got {self.serving_slots}")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0 (0 = one-token prefill), "
                f"got {self.prefill_chunk}")

    @classmethod
    def from_args(cls, argv: Optional[List[str]] = None) -> "FFConfig":
        """Parse the flags of the ported slices (the reference's names)."""
        p = argparse.ArgumentParser(add_help=False)
        p.add_argument("-e", "--epochs", type=int, default=1)
        p.add_argument("-b", "--batch-size", type=int, default=64)
        p.add_argument("--lr", "--learning-rate", dest="lr", type=float,
                       default=0.01)
        p.add_argument("--wd", "--weight-decay", dest="wd", type=float,
                       default=1e-4)
        p.add_argument("--flash-min-seq", dest="flash_min_seq", type=int,
                       default=DEFAULT_FLASH_MIN_SEQ)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", type=str, default="cuda")
        p.add_argument("--kv-page-size", dest="kv_page_size", type=int,
                       default=16)
        p.add_argument("--kv-pool-blocks", dest="kv_pool_blocks",
                       type=int, default=0)
        p.add_argument("--serving-slots", dest="serving_slots", type=int,
                       default=8)
        p.add_argument("--prefill-chunk", dest="prefill_chunk",
                       type=int, default=8)
        p.add_argument("--no-prefix-cache", dest="prefix_cache",
                       action="store_false")
        args, _ = p.parse_known_args(argv)
        return cls(
            epochs=args.epochs,
            batch_size=args.batch_size,
            learning_rate=args.lr,
            weight_decay=args.wd,
            flash_min_seq=args.flash_min_seq,
            seed=args.seed,
            device=args.device,
            kv_page_size=args.kv_page_size,
            kv_pool_blocks=args.kv_pool_blocks,
            serving_slots=args.serving_slots,
            prefill_chunk=args.prefill_chunk,
            prefix_cache=args.prefix_cache,
        )


def resolve_device(name: str) -> torch.device:
    """The torch device an FFConfig names.  A CUDA device on a machine
    without CUDA is an error: the port never carries on on the CPU
    unless the caller asked for it."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"FFConfig.device={name!r} but torch.cuda.is_available() is "
            "False: this machine has no usable CUDA device (pass "
            "device='cpu' to run on the host)")
    return dev
