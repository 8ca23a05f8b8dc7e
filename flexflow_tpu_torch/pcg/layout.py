"""Physical layout of 4-D CNN activations (flexflow_tpu/pcg/layout.py).

The PCG keeps the logical NCHW shapes of the reference's API; this pass
assigns each 4-D activation edge a physical layout.  On the card the
NHWC layout is torch's `channels_last` memory format: the tensor keeps
its NCHW shape and strides put channels minor-most.  cuDNN keeps it
through a convolution and torch through pooling and pointwise ops, and
the BatchNorm apply (P1, ops/kernels/bn_apply.py) reads it as [M, C]
rows with no copy.  The rules are the reference's:

  * layout-preferring ops (Conv2D, Pool2D, BatchNorm) execute in NHWC
    and emit NHWC;
  * layout-agnostic pointwise ops (ElementUnary, Dropout, Cast) pass
    what arrives straight through, and so does a same-shape
    ElementBinary (the residual add) whose inputs are both NHWC;
  * a Concat or Split whose 4-D inputs and outputs are all NHWC (the
    Inception branch joins) executes on the channels_last tensors and
    emits NHWC.  The reference remaps its axis; here the logical axis
    stays, since a channels_last tensor keeps its NCHW shape, and
    torch.cat of channels_last inputs returns a channels_last tensor.
    A channel slice of a channels_last tensor is contiguous in neither
    format, so Split materializes each part in channels_last;
  * every other consumer gets logical NCHW: the other shape ops among
    them (a ViT's patch flatten(2) is a Reshape of the conv's output).

For a ResNet or an Inception that is one conversion to channels_last at
the input and one back to NCHW before the head's Flat.  The executor
does the conversions.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..fftype import OperatorType

LOGICAL = "nchw"
NHWC = "nhwc"
PASS = "pass"

_PREFER = {OperatorType.CONV2D, OperatorType.POOL2D, OperatorType.BATCH_NORM}
_AGNOSTIC = {OperatorType.ELEMENT_UNARY, OperatorType.DROPOUT,
             OperatorType.CAST}
_REMAP = {OperatorType.CONCAT, OperatorType.SPLIT}


def _is_4d(pt) -> bool:
    return pt.shape.logical_rank == 4


def assign_layouts(graph) -> Tuple[Dict[int, str], Dict[int, str]]:
    """One topo walk -> (tensor guid -> layout, op guid -> exec layout).

    Tensor layouts record only NHWC entries; absent means logical.  Op
    exec layouts: "nhwc" (the executor gives every 4-D input in
    channels_last), "pass" (inputs used as stored), absent (logical:
    the executor makes any NHWC input NCHW-contiguous)."""
    t_layout: Dict[int, str] = {}
    op_layout: Dict[int, str] = {}
    for op in graph.topo_order():
        ot = op.op_type
        in_lay = [t_layout.get(t.guid, LOGICAL) for t in op.inputs]
        if ot in _PREFER and op.inputs and all(_is_4d(t) for t in op.inputs):
            op_layout[op.guid] = NHWC
        elif (ot in _AGNOSTIC and op.inputs and _is_4d(op.inputs[0])
              and in_lay[0] == NHWC):
            op_layout[op.guid] = PASS
        elif (ot == OperatorType.ELEMENT_BINARY and len(op.inputs) == 2
              and all(_is_4d(t) for t in op.inputs)
              and op.inputs[0].shape.logical_shape
              == op.inputs[1].shape.logical_shape
              and all(lay == NHWC for lay in in_lay)):
            # same-shape add (the residual join): no broadcasting, so the
            # physical permutation is transparent
            op_layout[op.guid] = PASS
        elif (ot in _REMAP and op.inputs
              and all(_is_4d(t) for t in op.inputs)
              and all(_is_4d(t) for t in op.outputs)
              and all(lay == NHWC for lay in in_lay)):
            op_layout[op.guid] = NHWC
        else:
            continue
        for out in op.outputs:
            if _is_4d(out):
                t_layout[out.guid] = NHWC
    return t_layout, op_layout
