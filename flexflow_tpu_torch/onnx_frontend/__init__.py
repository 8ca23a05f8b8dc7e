"""ONNX frontend of the port (flexflow_tpu/onnx_frontend): ONNXModel
lowers an ONNX graph (a path, wire bytes or a parsed model) onto the
port's FFModel; protowire reads and writes the wire format without the
`onnx` package, and module_to_onnx writes a torch CNN module as ONNX
wire bytes through it."""
from .export import module_to_onnx
from .model import ONNXModel, onnx_to_flexflow

__all__ = ["ONNXModel", "module_to_onnx", "onnx_to_flexflow"]
