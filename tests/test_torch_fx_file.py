"""The fx file route of the port (PyTorchModel.torch_to_file,
file_to_ff) against flexflow_tpu's on the CPU.

chip_smoke's small ViT (get_attr position table, view/permute/matmul
attention, LayerNorm, GELU, mean), its small ResNet (conv, BatchNorm,
pool, residual adds, flatten) and a small MLP with a bare parameter and
a buffer are written by both packages: the JSON lines are the same text
and the npz sidecars hold the same arrays.  Each package then replays
the OTHER's file (the ResNet and the MLP): the two graphs have the same
op names, types and shapes, and with the same weights their forwards
agree.  The port's replay equals its direct import (torch_to_ff) op for
op and output for output, the ViT's too: its attention adds a traced
shape tuple to a literal one (`x.size()[:-1] + (h, d)`), which the file
stores as a list, and the port's replay reads back as a tuple (the
reference's replay of that file raises; ROADMAP.md §3).

Tolerances, float32: forwards within 1e-5 of the output's scale
max(1, max|ref|) across the packages (XLA's and ATen's sums in other
orders); the port's replay against its direct import exactly."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flexflow_tpu as J  # noqa: E402
import flexflow_tpu_torch as T  # noqa: E402
from flexflow_tpu.torch_frontend import PyTorchModel as JPT  # noqa: E402
from flexflow_tpu.torch_frontend.model import \
    file_to_ff as jax_file_to_ff  # noqa: E402
from flexflow_tpu_torch.torch_frontend import (PyTorchModel,  # noqa: E402
                                               file_to_ff)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TOL = 1e-5
B, PX = 2, 32


def _scaled(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(np.asarray(ref, np.float32), np.float64)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


class BiasMLP(torch.nn.Module):
    """Linear layers around a bare parameter (a trainable const), a
    buffer (a frozen one), flatten, transpose and softmax."""

    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(3 * PX * PX, 16)
        self.shift = torch.nn.Parameter(0.1 * torch.randn(16))
        self.register_buffer("scale", torch.linspace(0.5, 1.5, 16))
        self.fc2 = torch.nn.Linear(16, 10)

    def forward(self, x):
        h = torch.relu(self.fc1(torch.flatten(x, 1)) + self.shift)
        h = (h * self.scale).unsqueeze(1).transpose(1, 2).squeeze(2)
        return torch.nn.functional.softmax(self.fc2(h), dim=-1)


def _module(name):
    torch.manual_seed(0)
    if name == "vit":
        return chip_smoke.vit_modules()[1]().eval()
    if name == "mlp":
        return BiasMLP().eval()
    return chip_smoke.resnet_modules()[2]().eval()


def _graph(ff):
    return [(op.name, op.op_type.value,
             [o.shape.logical_shape for o in op.outputs],
             [(s.name, s.shape.logical_shape) for s in op.weight_specs])
            for op in ff.layers.topo_order()]


def _compile(P, ff):
    kw = {"devices": jax.devices("cpu")[:1]} if P is J else {}
    ff.compile(optimizer=P.SGDOptimizer(lr=0.01), **kw)
    return ff


def _model(P):
    if P is J:
        ff = J.FFModel(J.FFConfig(batch_size=B, num_devices=1))
    else:
        ff = T.FFModel(T.FFConfig(batch_size=B, device="cpu"))
    return ff, ff.create_tensor([B, 3, PX, PX], name="input")


@pytest.mark.parametrize("name,consts", [("vit", ["pos"]), ("resnet", []),
                                         ("mlp", ["scale", "shift"])])
def test_both_packages_write_the_same_file(tmp_path, name, consts):
    module = _module(name)
    mine, theirs = tmp_path / "port.ff", tmp_path / "ref.ff"
    PyTorchModel(module).torch_to_file(str(mine))
    JPT(module).torch_to_file(str(theirs))
    assert mine.read_text() == theirs.read_text()
    assert mine.read_text().count("\n") > 8
    if not consts:
        assert not Path(f"{mine}.npz").exists()
        return
    with np.load(f"{mine}.npz") as a, np.load(f"{theirs}.npz") as b:
        assert sorted(a.files) == sorted(b.files) == consts
        for k in consts:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", ["resnet", "mlp"])
def test_files_cross_both_ways(tmp_path, name):
    module = _module(name)
    mine, theirs = tmp_path / "port.ff", tmp_path / "ref.ff"
    PyTorchModel(module).torch_to_file(str(mine))
    JPT(module).torch_to_file(str(theirs))
    # each package replays the other's file
    tf, x = _model(T)
    (tout,) = file_to_ff(str(theirs), tf, [x])
    jf, jx = _model(J)
    (jout,) = jax_file_to_ff(str(mine), jf, [jx])
    assert _graph(tf) == _graph(jf)
    assert tout.shape.logical_shape == jout.shape.logical_shape == (B, 10)
    _compile(T, tf)
    _compile(J, jf)
    jf.set_weights(tf.get_weights())
    feed = {"input": np.random.RandomState(1).randn(B, 3, PX, PX).astype(
        np.float32)}
    assert _scaled(tf.forward(feed).numpy(), jf.forward(feed)) <= TOL


@pytest.mark.parametrize("name", ["vit", "resnet", "mlp"])
def test_replay_equals_the_direct_import(tmp_path, name):
    module = _module(name)
    path = tmp_path / "m.ff"
    pt = PyTorchModel(module)
    pt.torch_to_file(str(path))
    direct, x = _model(T)
    pt.torch_to_ff(direct, [x])
    _compile(T, direct)
    pt.copy_weights(direct)
    replay, x = _model(T)
    file_to_ff(str(path), replay, [x])
    assert _graph(replay) == _graph(direct)
    _compile(T, replay)
    replay.set_weights(direct.get_weights())
    replay.set_state(direct.get_state())
    feed = {"input": np.random.RandomState(2).randn(B, 3, PX, PX).astype(
        np.float32)}
    np.testing.assert_array_equal(replay.forward(feed).numpy(),
                                  direct.forward(feed).numpy())
    with torch.no_grad():
        want = module(torch.from_numpy(feed["input"])).numpy()
    assert _scaled(direct.forward(feed).numpy(), want) <= 1e-4


def test_file_route_refuses_what_the_reference_refuses(tmp_path):
    class Masked(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = torch.nn.MultiheadAttention(8, 2, batch_first=True)

        def forward(self, x):
            return self.attn(x, x, x, need_weights=False)[0]

    with pytest.raises(ValueError, match="kwargs"):
        PyTorchModel(Masked()).torch_to_file(str(tmp_path / "m.ff"))
    with pytest.raises(ValueError, match="kwargs"):
        JPT(Masked()).torch_to_file(str(tmp_path / "j.ff"))
