"""The binary substitution catalog (.pb) (flexflow_tpu/pcg/taso_pb.py).

A TASO RuleCollection ships as proto2 wire bytes (what the reference's
`GraphSearchHelper` loads) and as a JSON twin written by its
`protobuf_to_json` converter.  `pb_to_dict` reads the wire form with the
port's protowire codec (onnx_frontend/protowire.py, no protobuf
dependency) into the converter's exact dict, so both forms parse to the
same rules; `dict_to_pb` writes that dict back as wire bytes.

Schema (the reference's tools/protobuf_to_json/rules.proto):
  Parameter.key=1/.value=2; Tensor.opId=1/.tsId=2;
  Operator.type=1/.input=2/.para=3;
  MapOutput.srcOpId=1/.dstOpId=2/.srcTsId=3/.dstTsId=4;
  Rule.srcOp=1/.dstOp=2/.mappedOutput=3; RuleCollection.rule=1.

The enum name tables are the converter's (protobuf_to_json.cc:14-119),
its "OP_CONSTANT_POOl" typo included, so that a .pb parse is the
converter's JSON byte for byte.  PM_ACTI and PM_PAD values stay raw
ints, as the converter emits them.
"""
from __future__ import annotations

from typing import List, Union

from ..onnx_frontend.protowire import _fields, _ld, _signed, _vi

# protobuf_to_json.cc:14-46 (OpType), index == enum value
OP_TYPE_NAMES: List[str] = [
    "OP_INPUT", "OP_WEIGHT", "OP_ANY", "OP_CONV2D", "OP_DROPOUT",
    "OP_LINEAR", "OP_POOL2D_MAX", "OP_POOL2D_AVG", "OP_RELU",
    "OP_SIGMOID", "OP_TANH", "OP_BATCHNORM", "OP_CONCAT", "OP_SPLIT",
    "OP_RESHAPE", "OP_TRANSPOSE", "OP_EW_ADD", "OP_EW_MUL", "OP_MATMUL",
    "OP_MUL", "OP_ENLARGE", "OP_MERGE_GCONV", "OP_CONSTANT_IMM",
    "OP_CONSTANT_ICONV", "OP_CONSTANT_ONE", "OP_CONSTANT_POOl",
    "OP_PARTITION", "OP_COMBINE", "OP_REPLICATE", "OP_REDUCE",
    "OP_EMBEDDING",
]

# protobuf_to_json.cc:81-99 (ParamType)
PARAM_NAMES: List[str] = [
    "PM_OP_TYPE", "PM_NUM_INPUTS", "PM_NUM_OUTPUTS", "PM_GROUP",
    "PM_KERNEL_H", "PM_KERNEL_W", "PM_STRIDE_H", "PM_STRIDE_W",
    "PM_PAD", "PM_ACTI", "PM_NUMDIM", "PM_AXIS", "PM_PERM",
    "PM_OUTSHUFFLE", "PM_MERGE_GCONV_COUNT", "PM_PARALLEL_DIM",
    "PM_PARALLEL_DEGREE",
]


def _enum_name(table: List[str], value: int, what: str) -> str:
    if 0 <= value < len(table):
        return table[value]
    raise ValueError(f"catalog .pb: unknown {what} enum value {value}")


def _msg(v, wt, what: str) -> bytes:
    """An embedded message must be length-delimited; anything else means
    the stream is not this schema."""
    if wt != 2:
        raise ValueError(f"catalog .pb: {what} field is not a message")
    return v


def _parse_tensor(buf: bytes) -> dict:
    t = {"_t": "Tensor", "opId": 0, "tsId": 0}
    for field, _wt, v in _fields(buf):
        if field == 1:
            t["opId"] = _signed(v)
        elif field == 2:
            t["tsId"] = v
    return t


def _parse_param(buf: bytes) -> dict:
    key = value = 0
    for field, _wt, v in _fields(buf):
        if field == 1:
            key = v
        elif field == 2:
            value = _signed(v)
    return {"_t": "Parameter",
            "key": _enum_name(PARAM_NAMES, key, "ParamType"),
            "value": value}


def _parse_operator(buf: bytes) -> dict:
    o = {"_t": "Operator", "type": "OP_ANY", "input": [], "para": []}
    for field, wt, v in _fields(buf):
        if field == 1:
            o["type"] = _enum_name(OP_TYPE_NAMES, v, "OpType")
        elif field == 2:
            o["input"].append(_parse_tensor(_msg(v, wt, "Operator.input")))
        elif field == 3:
            o["para"].append(_parse_param(_msg(v, wt, "Operator.para")))
    return o


_MAP_FIELDS = {1: "srcOpId", 2: "dstOpId", 3: "srcTsId", 4: "dstTsId"}


def _parse_map_output(buf: bytes) -> dict:
    m = {"_t": "MapOutput", "srcOpId": 0, "dstOpId": 0,
         "srcTsId": 0, "dstTsId": 0}
    for field, _wt, v in _fields(buf):
        if field in _MAP_FIELDS:
            m[_MAP_FIELDS[field]] = v
    return m


def _parse_rule(buf: bytes) -> dict:
    r = {"_t": "Rule", "srcOp": [], "dstOp": [], "mappedOutput": []}
    for field, wt, v in _fields(buf):
        if field == 1:
            r["srcOp"].append(_parse_operator(_msg(v, wt, "Rule.srcOp")))
        elif field == 2:
            r["dstOp"].append(_parse_operator(_msg(v, wt, "Rule.dstOp")))
        elif field == 3:
            r["mappedOutput"].append(
                _parse_map_output(_msg(v, wt, "Rule.mappedOutput")))
    return r


def pb_to_dict(src: Union[str, bytes]) -> dict:
    """A serialized GraphSubst.RuleCollection (a path or its bytes) as
    the converter's JSON dict, the rules named taso_rule_{i}
    (protobuf_to_json.cc:209-213)."""
    if isinstance(src, str):
        with open(src, "rb") as fh:
            src = fh.read()
    rules = []
    for field, wt, v in _fields(src):
        if field == 1:
            rules.append(_parse_rule(_msg(v, wt, "RuleCollection.rule")))
    for i, r in enumerate(rules):
        r["name"] = f"taso_rule_{i}"
    return {"_t": "RuleCollection", "rule": rules}


def _encode_operator(o: dict) -> bytes:
    out = _vi(1, OP_TYPE_NAMES.index(o["type"]))
    for t in o.get("input", []):
        out += _ld(2, _vi(1, t["opId"]) + _vi(2, t["tsId"]))
    for p in o.get("para", []):
        out += _ld(3, _vi(1, PARAM_NAMES.index(p["key"]))
                   + _vi(2, p["value"]))
    return out


def dict_to_pb(d: dict) -> bytes:
    """A RuleCollection dict (the JSON form) as proto2 wire bytes, every
    field written, in the schema's field order; `pb_to_dict` of the
    result names the rules taso_rule_{i}, as the wire form carries no
    names."""
    out = b""
    for r in d["rule"]:
        body = b"".join(_ld(1, _encode_operator(o)) for o in r["srcOp"])
        body += b"".join(_ld(2, _encode_operator(o)) for o in r["dstOp"])
        for m in r["mappedOutput"]:
            body += _ld(3, b"".join(_vi(f, m[name])
                                    for f, name in _MAP_FIELDS.items()))
        out += _ld(1, body)
    return out


def looks_like_pb(path: str) -> bool:
    """Binary-vs-JSON sniff on the raw first byte: a RuleCollection wire
    stream opens with the field-1 length-delimited key 0x0A.  0x0A is
    also a newline, so a JSON file led by one sniffs as pb:
    parse_rule_collection falls back to JSON when the pb parse fails."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(1)
    except OSError:
        return False
    return head == b"\x0a"
