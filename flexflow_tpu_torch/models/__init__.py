from .alexnet import build_alexnet
from .candle_uno import build_candle_uno
from .dlrm import build_dlrm, build_xdl
from .inception import build_inception_v3
from .mlp import build_mlp_unify
from .moe import build_moe_encoder, build_moe_mlp
from .nmt import build_nmt, greedy_decode
from .resnet import build_resnet50, build_resnext50
from .transformer import (bert_sp_strategy, bert_tp_strategy,
                          build_bert, build_gpt, build_transformer,
                          gpt_beam_search, gpt_generate, sample_next,
                          validate_sampling)

__all__ = ["bert_sp_strategy", "bert_tp_strategy", "build_alexnet", "build_bert", "build_candle_uno", "build_dlrm",
           "build_gpt", "build_inception_v3", "build_mlp_unify",
           "build_moe_encoder", "build_moe_mlp", "build_nmt",
           "build_resnet50", "build_resnext50", "build_transformer",
           "build_xdl", "gpt_beam_search", "gpt_generate", "greedy_decode",
           "sample_next", "validate_sampling"]
