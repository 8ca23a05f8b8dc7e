"""PyTorch frontend of the port: torch.fx symbolic trace -> FFModel
lowering (flexflow_tpu/torch_frontend), and `copy_weights`, which
carries a module's parameters and BatchNorm running statistics into the
compiled model."""
from .model import PyTorchModel

__all__ = ["PyTorchModel"]
