"""The port's Cascade Mask R-CNN (``slak_tpu_torch/downstream/detection.py``)
against ``slak_tpu.downstream.detection`` on the CPU, at the JAX tests'
sizes (64^2 images, ``_tiny_cfg``'s head, two images, three GT slots):

  * the box utilities, the delta coder, the anchors and the level mapping
    within 1e-5;
  * ``nms_fixed``: the kept indices and valid flags equal, with scores
    that tie and boxes that take no part (-inf);
  * ``roi_align`` and ``extract_roi_features`` within 1e-5 (the port aligns
    each RoI on its mapped level only);
  * ``assign_max_iou`` (both modes) and ``random_sample`` on JAX's
    uniforms: the masks equal;
  * the mask head's transposed conv through ``cascade_from_jax`` (the
    flip) within 1e-5;
  * ``cascade_loss`` with JAX's sampler draws fed in: the total and each
    loss within 1e-4, each gradient within 1e-3 of its scale, the BN
    running stats within 1e-5;
  * ``cascade_predict``: boxes, scores and labels of the valid slots and
    the masks within 1e-4.

The JAX loss and its gradients come from one jitted ``value_and_grad``
and the predictions from one jitted ``cascade_predict``, compiled side by
side in a module fixture; the rest of the JAX side runs eagerly.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slak_tpu.downstream import detection as JD
from slak_tpu_torch.downstream import detection as D
from slak_tpu_torch.utils.convert import cascade_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE, N, G = 64, 2, 3
HEAD = dict(in_channels=(8, 16, 24, 32), fpn_channels=16, num_classes=5,
            fc_out=32, rpn_sample=16, rcnn_sample=32, num_proposals=16,
            mask_convs=2, num_shared_convs=2)


def _close(got, want, tol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max()), 1e-3)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def rand_boxes(rng, n, size=SIZE):
    xy = rng.uniform(0, size - 8, (n, 2))
    wh = rng.uniform(4, size / 2, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, size)], 1).astype(
        np.float32)


def _inputs(rng):
    feats = [rng.standard_normal((N, c, SIZE // s, SIZE // s)).astype(
        np.float32) for s, c in zip((4, 8, 16, 32), (8, 16, 24, 32))]
    gb = np.stack([rand_boxes(rng, G) for _ in range(N)])
    gl = rng.integers(0, 5, (N, G)).astype(np.int32)
    gv = np.stack([[1, 1, 0]] * N).astype(np.float32)
    gm = (rng.random((N, G, SIZE // 2, SIZE // 2)) > 0.5).astype(np.float32)
    return feats, gb, gl, gv, gm


def _jax_draws(key, n_anchors, n_boxes):
    """The uniforms ``cascade_loss`` draws from ``key``, by sampler."""
    rngs = jax.random.split(key, N * 8).reshape(N, 8, -1)
    out = {}
    for name, slot, shape in [("rpn", 0, n_anchors)] + [
            (f"s{s}", 1 + s, n_boxes) for s in range(3)]:
        out[name] = []
        for i in range(N):
            k1, k2 = jax.random.split(rngs[i, slot])
            out[name].append(tuple(
                _t(jax.random.uniform(k, (shape,))) for k in (k1, k2)))
    return out


@pytest.fixture(scope="module")
def case():
    """The JAX head (random BN running stats), its port, the inputs, and
    the JAX loss, losses, gradients and predictions."""
    rng = np.random.default_rng(0)
    cfg_j = JD.DetHeadConfig(**HEAD)
    cfg = D.DetHeadConfig(**HEAD)
    # init_cascade's tree (traced, not run), drawn with numpy: nonzero
    # biases and BN running stats, so every layout is exercised
    shapes = jax.eval_shape(lambda k: JD.init_cascade(k, cfg_j),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.05 * rng.standard_normal(s.shape),
                              jnp.float32), shapes[0])
    for sp in params["stages"]:
        sp["bn"] = [dict(b, scale=b["scale"] + 1.0) for b in sp["bn"]]
    state = jax.tree_util.tree_map(
        lambda s: jnp.asarray(0.1 * rng.random(s.shape), jnp.float32),
        shapes[1])
    for st in state["stages"]:
        st["bn"] = [dict(b, var=b["var"] + 1.0) for b in st["bn"]]
    feats, gb, gl, gv, gm = _inputs(rng)
    feats_j = [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats]
    key = jax.random.PRNGKey(1)

    @jax.jit
    def loss_and_grads(params, state):
        def fn(p):
            tot, losses, new_state = JD.cascade_loss(
                p, state, feats_j, jnp.asarray(gb), jnp.asarray(gl),
                jnp.asarray(gv), jnp.asarray(gm), (SIZE, SIZE), key, cfg_j)
            return tot, (losses, new_state)
        (tot, (losses, new_state)), grads = jax.value_and_grad(
            fn, has_aux=True)(params)
        return tot, losses, new_state, grads

    predict = jax.jit(lambda p, s: JD.cascade_predict(
        p, s, feats_j, (SIZE, SIZE), cfg_j, max_dets=8))
    # the two programs compile in threads, side by side
    with ThreadPoolExecutor(2) as ex:
        fut = ex.submit(predict, params, state)
        tot, losses, new_state, grads = loss_and_grads(params, state)
        pred = fut.result()
    head = D.CascadeHead(cfg)
    head.load_state_dict(cascade_from_jax(params, state))
    n_anchors = sum((SIZE // s) ** 2 * 3 for s in cfg.strides)
    return dict(cfg=cfg, cfg_j=cfg_j, params=params, state=state,
                head=head, feats=feats, gt=(gb, gl, gv, gm),
                draws=_jax_draws(key, n_anchors, cfg.num_proposals + G),
                tot=float(tot), losses={k: float(v) for k, v in
                                        losses.items()},
                new_state=new_state, grads=grads,
                pred=[np.asarray(p) for p in pred])


def test_box_utilities_coder_anchors_levels():
    rng = np.random.default_rng(1)
    a, b = rand_boxes(rng, 12), rand_boxes(rng, 7)
    d = rng.standard_normal((7, 4)).astype(np.float32) * 3
    rois = np.concatenate([np.zeros((40, 1), np.float32),
                           rand_boxes(rng, 40, size=800)], 1)
    stds = (0.1, 0.1, 0.2, 0.2)
    hw = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]

    @jax.jit
    def jax_side(a, b, d, rois):
        return (JD.box_iou(a, b), JD.box_giou_pairwise(a[:7], b),
                JD.delta_encode(a[:7], b, stds),
                JD.delta_decode(a[:7], d, stds, (50, 40)),
                JD.map_roi_levels(rois, 4, 56),
                JD.make_anchors(hw, JD.DetHeadConfig()))

    iou, giou, enc, dec, lvl, anchors = jax_side(a, b, d, rois)
    _close(D.box_iou(_t(a), _t(b)), iou, 1e-5, "box_iou")
    _close(D.box_giou_pairwise(_t(a[:7]), _t(b)), giou, 1e-5, "giou")
    _close(D.delta_encode(_t(a[:7]), _t(b), stds), enc, 1e-5,
           "delta_encode")
    _close(D.delta_decode(_t(a[:7]), _t(d), stds, (50, 40)), dec, 1e-5,
           "delta_decode")
    for i, (p, j) in enumerate(zip(D.make_anchors(hw, D.DetHeadConfig()),
                                   anchors)):
        _close(p, j, 1e-6, f"anchors level {i}")
    np.testing.assert_array_equal(
        D.map_roi_levels(_t(rois), 4, 56).numpy(), np.asarray(lvl))


@pytest.mark.parametrize("ties", [False, True])
def test_nms_fixed_keeps_jax_indices(ties):
    rng = np.random.default_rng(2)
    boxes = rand_boxes(rng, 40)
    scores = -np.sort(-rng.random(40).astype(np.float32))
    if ties:
        # cascade_predict's case: many equal scores and boxes that take
        # no part
        scores = np.round(scores * 4) / 4
        scores[30:] = -np.inf
    keep_j, valid_j = JD.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                                     0.5, 24)
    keep, valid = D.nms_fixed(_t(boxes), _t(scores), 0.5, 24)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))


def test_roi_align_and_level_extraction():
    rng = np.random.default_rng(3)
    cfg = D.DetHeadConfig(**HEAD)
    feats = [rng.standard_normal((2, 5, SIZE // s, SIZE // s)).astype(
        np.float32) for s in (4, 8, 16, 32)]
    boxes = np.concatenate([rand_boxes(rng, 30, size=SIZE * 4),
                            # off the grid (no sample point exactly at -1,
                            # where a point's value jumps from 0 to the
                            # edge's and one rounding decides)
                            np.asarray([[-6.3, -5.1, 10, 9],
                                        [60, 60, 300, 280]], np.float32)])
    rois = np.concatenate([rng.integers(0, 2, (32, 1)).astype(np.float32),
                           boxes], 1)
    got = D.roi_align(_t(feats[0]), _t(rois), 7, 4)
    want = jax.jit(JD.roi_align, static_argnums=(2, 3))(
        jnp.asarray(feats[0].transpose(0, 2, 3, 1)), jnp.asarray(rois), 7, 4)
    _close(got.permute(0, 2, 3, 1), want, 1e-5, "roi_align")
    got = D.extract_roi_features([_t(f) for f in feats], _t(rois), 14, cfg)
    want = jax.jit(JD.extract_roi_features, static_argnums=(2, 3))(
        [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats],
        jnp.asarray(rois), 14, JD.DetHeadConfig(**HEAD))
    _close(got.permute(0, 2, 3, 1), want, 1e-5, "extract_roi_features")


def test_assign_and_sample_on_jax_uniforms():
    """The RPN's assignment (low-quality matches) and the cascade's."""
    rng = np.random.default_rng(4)
    gt = np.concatenate([rand_boxes(rng, 3), np.zeros((1, 4), np.float32)])
    gv = np.asarray([1, 1, 1, 0], np.float32)
    boxes = np.concatenate([gt[:2] + 1.0, rand_boxes(rng, 60)])
    for seed, args in enumerate(((0.7, 0.3, True, 0.3),
                                 (0.5, 0.5, False, 0.5))):
        key = jax.random.PRNGKey(7 + seed)

        @jax.jit
        def jax_side(boxes, gt, gv, key):
            pos, neg, arg = JD.assign_max_iou(boxes, gt, gv, *args)
            k1, k2 = jax.random.split(key)
            return ((pos, neg, arg),
                    JD.random_sample(key, pos, neg, 16, 0.25),
                    [jax.random.uniform(k, (62,)) for k in (k1, k2)])

        want, (ps_j, ns_j), u = jax_side(boxes, gt, gv, key)
        got = D.assign_max_iou(_t(boxes), _t(gt), _t(gv), *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        ps, ns, _ = D.random_sample(got[0], got[1], 16, 0.25,
                                    uniforms=tuple(_t(v) for v in u))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(ps_j))
        np.testing.assert_array_equal(ns.numpy(), np.asarray(ns_j))


def test_mask_head_deconv_flip(case):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 16, 14, 14)).astype(np.float32)
    want = JD.mask_head_forward(case["params"]["mask"],
                                jnp.asarray(x.transpose(0, 2, 3, 1)))
    got = D.mask_head_forward(case["head"].mask, _t(x))
    _close(got.detach().permute(0, 2, 3, 1), want, 1e-5, "mask head")


def test_cascade_loss_and_gradients(case):
    head = case["head"]
    head.load_state_dict(cascade_from_jax(case["params"], case["state"]))
    feats = [_t(f) for f in case["feats"]]
    gb, gl, gv, gm = (_t(a) for a in case["gt"])
    tot, losses, _ = D.cascade_loss(head, feats, gb, gl.long(), gv, gm,
                                    (SIZE, SIZE), case["cfg"],
                                    draws=case["draws"])
    tot.backward()
    assert abs(tot.item() - case["tot"]) <= 1e-4 * abs(case["tot"])
    for k, v in case["losses"].items():
        assert abs(losses[k].item() - v) <= 1e-4 * max(abs(v), 1e-3), k
    want = cascade_from_jax(case["grads"])
    for n, p in head.named_parameters():
        _close(p.grad, want[n].numpy(), 1e-3, f"grad {n}")
    bn = cascade_from_jax(case["params"], case["new_state"])
    for n, b in head.named_buffers():
        if "running" in n:
            _close(b, bn[n].numpy(), 1e-5, n)


def test_cascade_predict_valid_slots(case):
    head = case["head"]
    head.load_state_dict(cascade_from_jax(case["params"], case["state"]))
    boxes, scores, labels, masks = D.cascade_predict(
        head, [_t(f) for f in case["feats"]], (SIZE, SIZE), case["cfg"],
        max_dets=8)
    jb, js, jl, jm = case["pred"]
    assert boxes.shape == (N, 8, 4) and masks.shape == (N, 8, 28, 28)
    _close(scores, js, 1e-4, "scores")
    valid = js > 0
    assert valid.any()
    _close(boxes.numpy()[valid], jb[valid], 1e-4, "boxes")
    np.testing.assert_array_equal(labels.numpy()[valid], jl[valid])
    _close(masks.numpy()[valid], jm[valid], 1e-4, "masks")
