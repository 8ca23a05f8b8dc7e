"""PyTorch frontend of the port: torch.fx symbolic trace -> FFModel
lowering (flexflow_tpu/torch_frontend), `copy_weights`, which carries a
module's parameters and BatchNorm running statistics into the compiled
model, and the file route (`PyTorchModel.torch_to_file`, `file_to_ff`)."""
from .model import PyTorchModel, file_to_ff

__all__ = ["PyTorchModel", "file_to_ff"]
