"""Mixup / CutMix and random erasing of the port against ``slak_tpu.data``.

The two packages draw from different streams (a ``torch.Generator``
against JAX keys), so the comparison is in two parts:

  * with the draws given, the arithmetic: ``slak_tpu``'s beta and box
    samplers replaced by functions returning set values (and the port's
    likewise), mixup and CutMix in the batch, elem and pair modes (an odd
    batch in pair mode) give the same mixed images and soft targets,
    exactly; random erasing, fed the draws ``slak_tpu``'s own keys make,
    gives ``slak_tpu``'s erased batch exactly, in the three fill modes;
  * the draws by count and distribution (``FIDELITY.md``: the streams
    differ): over many samples in elem mode, the share of CutMix and the
    distribution of the final lam; the share of erased images and of the
    erased area; both against ``slak_tpu``'s (two-sample KS test, p > 1e-4)
    and against their expectations.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from slak_tpu.data import mixup as jmix
from slak_tpu_torch.data import mixup as mix

# the packages' __init__ bind the function random_erasing over the module
jre = importlib.import_module("slak_tpu.data.random_erasing")
re_ = importlib.import_module("slak_tpu_torch.data.random_erasing")

N, H, W, C = 5, 12, 14, 3
CLASSES = 10
LAMS = {0.8: np.linspace(0.15, 0.85, N).astype(np.float32),
        1.0: np.linspace(0.9, 0.3, N).astype(np.float32)}


def _batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    y = np.array([1, 4, 7, 2, 9], dtype=np.int64)
    return x, y


def test_mixup_target_matches_slak_tpu():
    _, y = _batch()
    for lam in (np.float32(0.3), LAMS[0.8]):
        for smoothing in (0.0, 0.1):
            want = jmix.mixup_target(jnp.asarray(y), CLASSES,
                                     jnp.asarray(lam), smoothing)
            got = mix.mixup_target(torch.from_numpy(y), CLASSES,
                                   torch.from_numpy(np.asarray(lam)),
                                   smoothing)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_box(rng, h, w, lam, cfg):
    y1 = jnp.floor(lam * 5).astype(jnp.int32)
    x1 = jnp.floor(lam * 3).astype(jnp.int32)
    return y1, y1 + 3 + jnp.floor(lam * 4).astype(jnp.int32), x1, x1 + 4


def _port_boxes(gen, h, w, lam, cfg):
    y1 = torch.floor(lam * 5).long()
    x1 = torch.floor(lam * 3).long()
    return torch.stack([y1, y1 + 3 + torch.floor(lam * 4).long(), x1,
                        x1 + 4], 1)


@pytest.mark.parametrize("mode,cutmix", [("batch", False), ("batch", True),
                                         ("elem", False), ("elem", True),
                                         ("pair", True)])
def test_mix_with_given_draws_matches_slak_tpu(monkeypatch, mode, cutmix):
    """switch_prob 1 (0) makes every draw CutMix (mixup); lam and the box
    come from the replaced samplers."""
    x, y = _batch()
    monkeypatch.setattr(jmix, "_beta", lambda rng, a, shape=(): jnp.asarray(
        LAMS[a][0] if shape == () else LAMS[a][:shape[0]]))
    monkeypatch.setattr(jmix, "_cut_box", _jax_box)
    monkeypatch.setattr(mix, "_beta", lambda gen, a, shape, device:
                        torch.from_numpy(LAMS[a][:shape[0]]))
    monkeypatch.setattr(mix, "_boxes", _port_boxes)
    kw = dict(mode=mode, switch_prob=1.0 if cutmix else 0.0,
              num_classes=CLASSES)
    # eager: under jit XLA may contract x * lam + x' * (1 - lam) into FMAs
    want_x, want_t = jmix.mixup_cutmix(jax.random.PRNGKey(0), jnp.asarray(x),
                                       jnp.asarray(y), jmix.MixupConfig(**kw))
    got_x, got_t = mix.mixup_cutmix(torch.Generator().manual_seed(0),
                                    torch.from_numpy(x), torch.from_numpy(y),
                                    mix.MixupConfig(**kw))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert not np.array_equal(got_x.numpy(), x)


def _jax_erase_draws(rng, shape, cfg):
    """The draws slak_tpu's ``_erase_one`` makes for each image (one
    round), from its own key splits."""
    n, h, w, c = shape

    def one(key):
        k = jax.random.split(key, 6)
        target = h * w * jax.random.uniform(k[1], minval=cfg.min_area,
                                            maxval=cfg.max_area)
        ar = jnp.exp(jax.random.uniform(k[2], minval=jnp.log(cfg.min_aspect),
                                        maxval=jnp.log(cfg.max_aspect)))
        eh = jnp.clip(jnp.sqrt(target * ar).astype(jnp.int32), 1, h)
        ew = jnp.clip(jnp.sqrt(target / ar).astype(jnp.int32), 1, w)
        fill = {"pixel": lambda: jax.random.normal(k[5], (h, w, c)),
                "rand": lambda: jax.random.normal(k[5], (1, 1, c)),
                "const": lambda: jnp.zeros((1, 1, c))}[cfg.mode]()
        return dict(apply=jax.random.uniform(k[0]) < cfg.prob, eh=eh, ew=ew,
                    top=jax.random.randint(k[3], (), 0,
                                           jnp.maximum(h - eh, 1)),
                    left=jax.random.randint(k[4], (), 0,
                                            jnp.maximum(w - ew, 1)),
                    fill=fill)

    keys = jax.random.split(jax.random.fold_in(rng, 0), n)
    out = jax.vmap(one)(keys)
    return re_.EraseDraws(**{k: torch.from_numpy(np.array(v))
                             for k, v in out.items()})


def test_erasing_with_given_draws_matches_slak_tpu():
    x, _ = _batch()
    rng = jax.random.PRNGKey(3)
    for mode in re_.ERASE_MODES:
        jcfg = jre.RandomErasingConfig(prob=0.6, mode=mode)
        want = jre.random_erasing(rng, jnp.asarray(x), jcfg)
        draws = _jax_erase_draws(rng, x.shape, jcfg)
        assert bool(draws.apply.any())
        got = re_.erase_apply(torch.from_numpy(x), draws)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=mode)


def _final_lams(images_targets, y):
    _, t = images_targets
    t = np.asarray(t)
    return t[np.arange(len(y)), y]


def test_draws_match_slak_tpu_in_distribution():
    """4096 samples in elem mode (labels i and 4095 - i never equal): the
    final lam (mixup's beta(0.8), or CutMix's box-corrected one) and the
    CutMix share; erasing's share of erased images and erased areas."""
    n, h, w = 4096, 16, 16
    y = np.arange(n) % 2048
    y[n // 2:] += 2048                  # partner of i is n-1-i: other label
    x = np.zeros((n, h, w, 1), np.float32)
    cfg = dict(mode="elem", label_smoothing=0.0, num_classes=4096)
    want = _final_lams(jax.jit(lambda k, a, b: jmix.mixup_cutmix(
        k, a, b, jmix.MixupConfig(**cfg)))(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y)), y)
    gen = torch.Generator().manual_seed(0)
    d = mix.draw_mix(gen, n, h, w, mix.MixupConfig(**cfg), "cpu")
    got = _final_lams(mix.mix_apply(torch.from_numpy(x), torch.from_numpy(y),
                                    d, mix.MixupConfig(**cfg)), y)
    assert stats.ks_2samp(got, want).pvalue > 1e-4
    share = float(d.use_cutmix.float().mean())
    assert abs(share - 0.5) < 4 * (0.25 / n) ** 0.5
    mixup_lams = d.lam_mix[~d.use_cutmix].numpy()
    assert stats.kstest(mixup_lams, stats.beta(0.8, 0.8).cdf).pvalue > 1e-4

    xe = np.ones((n, h, w, 1), np.float32) * 7.0
    jcfg = jre.RandomErasingConfig(mode="const")
    jer = np.asarray(jax.jit(lambda k, a: jre.random_erasing(k, a, jcfg))(
        jax.random.PRNGKey(1), jnp.asarray(xe)))
    ter = re_.random_erasing(torch.Generator().manual_seed(1),
                             torch.from_numpy(xe),
                             re_.RandomErasingConfig(mode="const")).numpy()
    areas_w = (jer == 0).reshape(n, -1).sum(1)
    areas_g = (ter == 0).reshape(n, -1).sum(1)
    for a in (areas_w, areas_g):
        assert abs((a > 0).mean() - 0.25) < 4 * (0.25 * 0.75 / n) ** 0.5
    assert stats.ks_2samp(areas_g[areas_g > 0],
                          areas_w[areas_w > 0]).pvalue > 1e-4
