from .alexnet import build_alexnet
from .candle_uno import build_candle_uno
from .dlrm import build_dlrm, build_xdl
from .inception import build_inception_v3
from .mlp import build_mlp_unify
from .moe import build_moe_encoder, build_moe_mlp
from .resnet import build_resnet50, build_resnext50
from .transformer import (build_bert, build_gpt, build_transformer,
                          sample_next, validate_sampling)

__all__ = ["build_alexnet", "build_bert", "build_candle_uno", "build_dlrm",
           "build_gpt", "build_inception_v3", "build_mlp_unify",
           "build_moe_encoder", "build_moe_mlp", "build_resnet50",
           "build_resnext50", "build_transformer", "build_xdl",
           "sample_next", "validate_sampling"]
