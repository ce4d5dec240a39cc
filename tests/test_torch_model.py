"""The port's model (slak_tpu_torch) against slak_tpu on the CPU.

A tiny SLaK (depths (1,1,2,1), dims (8,16,24,32), kernels (31,31,31,7,5),
10 classes) with jittered params and BN state: the JAX ``apply`` on its
plain route (``conv_impl="xla", mlp_impl="xla"``) against the port on
``device="cpu"`` with the same weights through ``from_jax_params``. The
JAX interpret-mode kernel route is held against this plain route by
tests/test_model.py, and each kernel by tests/test_torch_ops.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.models import slak as M
from slak_tpu.train.engine import make_eval_step as jax_make_eval_step
from slak_tpu.utils.convert import convert_state_dict
from slak_tpu_torch.models import create_model, merge_model
from slak_tpu_torch.models.slak import SLaK, SLaKConfig, apply
from slak_tpu_torch.train.engine import make_eval_step
from slak_tpu_torch.utils.convert import from_jax_params

TINY = dict(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32),
            kernel_size=(31, 31, 31, 7, 5), num_classes=10)
TOL = 2e-4      # fp32, the same math with sums in another order


@pytest.fixture(scope="module")
def jax_model():
    """(cfg, params, state, images): the JAX trees come from a freshly
    initialized port model through slak_tpu's own converter (cheaper than
    JAX's op-by-op init here), then every leaf is jittered."""
    rng = np.random.default_rng(0)
    cfg = M.SLaKConfig(conv_impl="xla", mlp_impl="xla", **TINY)
    init = create_model("SLaK_debug", device="cpu", seed=2,
                        kernel_size=TINY["kernel_size"], num_classes=10)
    params, state = convert_state_dict(init.state_dict())

    def jitter(tree):
        leaves, treedef = jax.tree_util.tree_flatten(tree)
        return jax.tree_util.tree_unflatten(treedef, [
            np.asarray(leaf) + 0.05 * np.abs(
                rng.standard_normal(leaf.shape).astype(np.float32))
            for leaf in leaves])

    params, state = jitter(params), jitter(state)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    return cfg, params, state, x


def _port(params, state):
    model = SLaK(SLaKConfig(**TINY)).eval()
    model.load_state_dict(from_jax_params(params, state))
    return model


def test_eval_forward_matches_slak_tpu(jax_model):
    cfg, params, state, x = jax_model
    want, _ = M.apply(params, state, jnp.asarray(x), cfg=cfg, train=False)
    got = apply(_port(params, state), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_merge_model_matches_slak_tpu(jax_model):
    """The reparameterized model (one K x K conv per block, through the
    same K1 route) vs JAX ``merge_model`` + ``apply``, and vs the unmerged
    port."""
    cfg, params, state, x = jax_model
    merged = M.merge_model(params, state, cfg)
    want, _ = M.apply(merged, state, jnp.asarray(x), cfg=cfg, train=False)
    model = _port(params, state)
    mm = merge_model(model)
    lk = mm.stages[0][0].large_kernel
    assert hasattr(lk, "lkb_reparam") and not hasattr(lk, "LoRA1")
    assert tuple(lk.lkb_reparam.weight.shape) == (8, 1, 31, 31)
    got = apply(mm, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    unmerged = apply(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), unmerged.numpy(), rtol=TOL,
                               atol=TOL)


def test_eval_step_matches_slak_tpu(jax_model):
    """loss, acc1 and acc5 of ``make_eval_step`` equal JAX's."""
    cfg, params, state, x = jax_model
    labels = np.array([3, 7], dtype=np.int32)
    want = jax_make_eval_step(M.SLaK(cfg))(params, state,
                                           (jnp.asarray(x),
                                            jnp.asarray(labels)))
    got = make_eval_step(_port(params, state))(
        (torch.from_numpy(x), torch.from_numpy(labels).long()))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=TOL)
    for k in ("acc1", "acc5", "n"):
        assert got[k].item() == float(want[k])


def test_state_dict_round_trips_through_slak_tpu_converter(jax_model):
    """from_jax_params inverts slak_tpu's convert_state_dict: the port's
    state_dict (the reference's names) converts back to the same trees."""
    _, params, state, _ = jax_model
    p2, s2 = convert_state_dict(_port(params, state).state_dict())
    for a, b in ((params, p2), (state, s2)):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb
        for u, v in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_state_dict_names_are_the_reference_names():
    model = create_model("SLaK_debug", device="cpu", kernel_size=(7, 7, 7,
                                                                  7, 5))
    keys = set(model.state_dict())
    for k in ("downsample_layers.0.0.weight", "downsample_layers.0.1.bias",
              "downsample_layers.1.0.weight", "downsample_layers.1.1.weight",
              "stages.0.0.large_kernel.LoRA1.conv.weight",
              "stages.0.0.large_kernel.LoRA2.bn.running_var",
              "stages.0.0.large_kernel.small_conv.bn.weight",
              "stages.0.0.norm.weight", "stages.0.0.pwconv1.weight",
              "stages.0.0.pwconv2.bias", "stages.0.0.gamma", "norm.weight",
              "head.weight"):
        assert k in keys, k
    assert not model.training
    assert model.stages[0][0].gamma.detach().eq(1e-6).all()


def test_create_model_without_device_needs_cuda(monkeypatch):
    """Entry points run on CUDA unless the CPU is asked for: with no CUDA
    device and no device given they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("SLaK_debug")
    assert next(create_model("SLaK_debug", device="cpu").parameters()
                ).device.type == "cpu"


def test_port_imports_neither_jax_nor_slak_tpu():
    """Importing every slak_tpu_torch module leaves jax and slak_tpu out of
    sys.modules (run in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import slak_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    slak_tpu_torch.__path__, 'slak_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or\n"
        "             n.startswith(('jax.', 'slak_tpu.')) or n == 'slak_tpu')\n"
        "print(len(names))\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 19


def test_port_modules_are_walked():
    """The import-isolation walk above reaches the train slice's modules."""
    import pkgutil
    import slak_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(slak_tpu_torch.__path__,
                                                   "slak_tpu_torch.")}
    for n in ("ops.dwconv_wgrad", "ops.batchnorm", "sparsity.masking",
              "train.optim", "train.ema", "train.engine", "train.losses",
              "utils.convert"):
        assert "slak_tpu_torch." + n in names, n
