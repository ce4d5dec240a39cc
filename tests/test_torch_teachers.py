"""The KD teacher zoo of the port (``slak_tpu_torch/models/{vit, swin,
cswin, resnet, mobile}.py``) and its checkpoint converter
(``slak_tpu_torch/utils/convert_teachers.py``) against ``slak_tpu`` on the
CPU.

Each family at a tiny configuration (those of ``tests/test_teachers.py``),
its JAX parameters and BN state jittered from a seed, through
``teacher_from_jax`` into the port: float32 logits and feature within
2e-4 of their scale against the JAX ``apply``; the port's state dict
through the JAX ``convert_*_state_dict`` equal to the JAX parameters
exactly; a ``.pth`` written with a ``module.`` prefix under ``model``
through ``load_teacher_checkpoint`` giving the same logits. Swin runs maps
larger than its window (the shift mask), ResNet-D an odd map at a strided
shortcut (XLA's ``"SAME"`` average pool), MobileNet's stride-2 stem at
unit-scale weights, where XLA's (0, 1) padding and torch's (1, 1) differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from slak_tpu.models import cswin as JC
from slak_tpu.models import mobile as JM
from slak_tpu.models import resnet as JR
from slak_tpu.models import swin as JS
from slak_tpu.models import vit as JV
from slak_tpu.utils import convert_teachers as JCT
from slak_tpu_torch.models import mobile, resnet, zoo
from slak_tpu_torch.utils.convert_teachers import (load_teacher_checkpoint,
                                                   teacher_from_jax)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-4
MB_V3 = dict(blocks=((1, 8, 3, 1, 0.0, "hswish"),
                     (4, 12, 3, 2, 0.25, "hswish"),
                     (3, 12, 5, 1, 0.25, "hswish")),
             stem_ch=8, head_ch=24, num_classes=10)
MB_EFF = dict(blocks=((1, 8, 3, 1, 0.25, "swish"),
                      (6, 12, 5, 2, 0.25, "swish"),
                      (6, 12, 3, 1, 0.25, "swish")),
              stem_ch=8, head_ch=24, num_classes=10)
# name, JAX module, JAX config keywords, image side, stateful (BN)
CASES = {
    "vit": ("vit_base_patch16_224", JV,
            dict(embed_dim=32, num_heads=4, depth=2, img_size=64,
                 num_classes=10), 64, False),
    "swin": ("swin_tiny_patch4_window7_224", JS,
             dict(embed_dim=16, depths=(1, 2, 1, 1), num_heads=(2, 2, 4, 4),
                  window=2, img_size=64, num_classes=10), 64, False),
    "cswin": ("cswin_tiny", JC,
              dict(embed_dim=16, depths=(1, 1, 1, 1), split_sizes=(1, 2, 4, 4),
                   num_heads=(2, 2, 4, 4), img_size=64, num_classes=10),
              64, False),
    "resnet": ("resnet26d", JR, dict(layers=(1, 1, 1, 1), width=16,
                                     num_classes=10), 50, True),
    "mobilenetv3": ("mobilenetv3_large_100", JM, MB_V3, 32, True),
    "efficientnet": ("efficientnet_b0", JM, MB_EFF, 32, True),
}


_CONVERT = {"vit": JCT.convert_vit_state_dict,
            "swin": JCT.convert_swin_state_dict,
            "cswin": JCT.convert_cswin_state_dict,
            "resnet": JCT.convert_resnet_state_dict,
            "mobilenetv3": JCT.convert_mobilenet_state_dict,
            "efficientnet": JCT.convert_mobilenet_state_dict}


def _jitter(tree, rng, scale=0.05):
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32) + scale * rng.standard_normal(
            np.shape(v)).astype(np.float32), tree)


def _bn_state(tree, rng):
    """Running means N(0, 0.1), variances in [0.5, 1.5)."""
    def leaf(path, v):
        key = jax.tree_util.keystr(path)
        if key.endswith("['var']"):
            return 0.5 + rng.random(np.shape(v)).astype(np.float32)
        return 0.1 * rng.standard_normal(np.shape(v)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def families():
    """Per family: (port name, config, params, state, images, JAX logits,
    JAX feature). The JAX parameters are a port teacher's random ones
    through the JAX converter, jittered; the JAX ``apply`` jitted once,
    the families compiled in three threads."""
    import concurrent.futures
    rng = np.random.default_rng(0)
    out = {}
    for fam, (name, mod, kw, side, stateful) in CASES.items():
        port = zoo.registry()[name](**kw).reset_parameters(
            torch.Generator().manual_seed(0))
        tree = _CONVERT[fam](port.state_dict())
        if stateful:
            p, s = _jitter(tree[0], rng), _bn_state(tree[1], rng)
        else:
            p, s = _jitter(tree, rng), None
        x = rng.standard_normal((2, side, side, 3)).astype(np.float32)
        out[fam] = (name, kw, p, s, x)

    def apply(fam):
        name, mod, kw, _, _ = CASES[fam]
        _, _, p, s, x = out[fam]
        args = (p, jnp.asarray(x)) if s is None else (p, s, jnp.asarray(x))
        lj, fj = jax.jit(getattr(mod, name)(**kw).apply)(*args)
        return np.asarray(lj), np.asarray(fj)

    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        refs = dict(zip(out, ex.map(apply, out)))
    return {fam: out[fam] + refs[fam] for fam in out}


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    bound = TOL * max(float(np.abs(want).max()), 1e-3)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("fam", list(CASES))
def test_teacher_matches_slak_tpu(families, fam):
    """Logits and feature against the JAX apply; the port's state dict
    through the JAX converter equal to the JAX parameters exactly."""
    name, kw, p, s, x, lj, fj = families[fam]
    model = teacher_from_jax(name, p, s, device="cpu", **kw)
    logits, feat = model.teacher_apply()(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and not logits.requires_grad
    assert all(not q.requires_grad for q in model.parameters())
    _close(logits, lj, f"{fam} logits")
    _close(feat, fj, f"{fam} feature")
    back = _CONVERT[fam](model.state_dict())
    want = (p, s) if s is not None else p
    got_l, got_t = jax.tree_util.tree_flatten(back)
    want_l, want_t = jax.tree_util.tree_flatten(want)
    assert got_t == want_t
    for g, w in zip(got_l, want_l):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_load_teacher_checkpoint_from_wrapped_pth(families, tmp_path):
    """Swin (with a timm buffer the port recomputes) and ResNet-D from a
    .pth holding ``module.``-prefixed names under ``model``."""
    for fam in ("swin", "resnet"):
        name, kw, p, s, x, lj, _ = families[fam]
        model = teacher_from_jax(name, p, s, device="cpu", **kw)
        sd = {"module." + k: v for k, v in model.state_dict().items()}
        if fam == "swin":      # timm's buffers, recomputed by the port
            sd["module.layers.0.blocks.0.attn.relative_position_index"] = \
                torch.zeros(16, 16, dtype=torch.int64)
        path = str(tmp_path / f"{fam}.pth")
        torch.save({"model": sd, "epoch": 3}, path)
        got = load_teacher_checkpoint(path, name, device="cpu", **kw)
        logits, _ = got.teacher_apply()(torch.from_numpy(x))
        _close(logits, lj, f"{fam} logits from the .pth")
    with pytest.raises(ValueError):
        load_teacher_checkpoint(path, "unknown_model", device="cpu")


def test_edges_follow_slak_tpu(families):
    """Swin's shift mask (the tiny Swin's maps, 16, 8 and 4 against a
    window of 2, shift on its odd blocks; the mask checked on an 8 x 8 map
    with a window of 4); ResNet-D's shortcut pool on an odd map (XLA's
    "SAME" window sum / 4, where torch's ceil-mode pool differs);
    MobileNet's stride-2 stem at unit-scale weights on a 32^2 map (XLA's
    "SAME" (0, 1) padding; torch's symmetric (1, 1) differs by O(1))."""
    _, kw, _, _, _, _, _ = families["swin"]
    from slak_tpu_torch.models.swin import shift_mask
    assert kw["img_size"] // 4 > kw["window"]
    h = w = 8
    win, sh = 4, 2
    got = shift_mask(h, w, win, sh)
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -sh), slice(-sh, None)):
        for ws in (slice(0, -win), slice(-win, -sh), slice(-sh, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, win * win)
    want = np.where(mw[:, :, None] != mw[:, None, :], -100.0, 0.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got != 0).any()

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 13, 13, 5)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), 0.0, jax.lax.add,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "SAME") / 4
    got = resnet.avg_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    ceil = torch.nn.AvgPool2d(2, 2, ceil_mode=True, count_include_pad=False)(
        torch.from_numpy(x).permute(0, 3, 1, 2))
    assert float((ceil - got).abs().max()) > 0.1

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 8)).astype(np.float32)
    want = JM._conv(jnp.asarray(x), {"w": jnp.asarray(w)}, 2)
    stem = torch.nn.Conv2d(3, 8, 3, 2, bias=False)
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = mobile.conv_same(xt, stem, 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    sym = F.conv2d(xt, stem.weight, None, 2, 1)
    assert float((sym - got).abs().max().detach()) > 1.0
