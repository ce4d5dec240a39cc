"""The channel-parallel eval of the port (``slak_tpu_torch.parallel.tp``)
on the CPU, over 2 and 3 spawned gloo ranks (3 pads every stage width).

A small SLaK (depths 1/1/2/1, widths 8/13/25/38: 13 and 25 odd, none but
38 divisible by 3) with jittered weights and BN state, decomposed and not,
at 32^2: each rank's logits against ``slak_tpu.parallel.tp.make_tp_apply``
on a mesh of the same size within 2e-4 (``tests/test_tp.py``'s tolerance)
and against the port's one-process eval; every stage's shards gathered
from the ranks hold the one-process stage output in the real lanes and
exactly 0 in the padded ones (``pad_for_tp``). The train CLI's
``--eval true --tp_eval true --n_devices 2`` (gloo) on a reference-style
checkpoint: loss, top-1 and top-5 within 1e-4 of the one-process
``--eval``, on all 9 val images.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from slak_tpu_torch.models.slak import SLaK, SLaKConfig
from slak_tpu_torch.parallel.tp import make_tp_apply, pad_for_tp
from slak_tpu_torch.train.launch import run_ranks


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread while this file's tests run: their tensors
    are small, and the suite's parallel workers would otherwise each start
    a thread a core and oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIMEOUT = 60
CLI = ["--device", "cpu", "--model", "SLaK_debug", "--kernel_size", "13",
       "11", "9", "7", "5", "--Decom", "true", "--data_set", "synthetic",
       "--input_size", "32", "--use_bf16", "false", "--num_workers", "2",
       "--nb_classes", "3", "--batch_size", "4", "--synthetic_len", "36",
       "--eval", "true"]
DIMS = (8, 13, 25, 38)
RANKS = (2, 3)
TOL = 2e-4


def _cfg(decom):
    return dict(depths=(1, 1, 2, 1), dims=DIMS, kernel_size=(13, 11, 9, 7, 5),
                num_classes=10, decom=decom, branch_bn=True)


def _model(sd, decom):
    model = SLaK(SLaKConfig(**_cfg(decom)))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval()


def _tp_worker(a):
    """Per decom mode: this rank's logits and its four stage shards."""
    out = {}
    x = torch.from_numpy(a["x"])
    for decom, sd in a["sd"].items():
        tp = make_tp_apply(_model(sd, decom))
        stages = tp.forward_features(x.permute(0, 3, 1, 2).contiguous(),
                                     return_stages=True)
        out[decom] = (tp(x).numpy(), [s.numpy() for s in stages])
    return out


def _inputs():
    rng = np.random.default_rng(0)
    sds = {}
    for decom in (True, False):
        model = SLaK(SLaKConfig(**_cfg(decom))).reset_parameters(
            torch.Generator().manual_seed(1))
        sd = {}
        for k, v in model.state_dict().items():
            v = v.numpy()
            if v.dtype == np.float32:   # make every fold and block matter
                v = v + 0.05 * np.abs(rng.standard_normal(v.shape)).astype(
                    np.float32)
            sd[k] = v
        sds[decom] = sd
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    return {"sd": sds, "x": x}


def _jax_logits(a, d, decom):
    import jax.numpy as jnp
    from slak_tpu.models import slak as M
    from slak_tpu.parallel import make_mesh
    from slak_tpu.parallel.tp import AXIS, make_tp_apply as jax_tp
    from slak_tpu.utils.convert import convert_state_dict
    params, state = convert_state_dict(
        {k: torch.from_numpy(v) for k, v in a["sd"][decom].items()})
    model = M.SLaK(M.SLaKConfig(conv_impl="xla", drop_path_rate=0.0,
                                **_cfg(decom)))
    fn = jax_tp(model, make_mesh(d, axis_name=AXIS))
    return np.asarray(fn(params, state, jnp.asarray(a["x"])))


def _cli_eval(path, extra):
    from slak_tpu_torch.train.main import main, parse_args, spawn_ranks
    args = parse_args(CLI + ["--finetune", path] + extra)
    if args.n_devices:
        return spawn_ranks(args, TIMEOUT)[0]
    return main(args)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, {d: the ranks' results}, {(d, decom): slak_tpu's logits},
    {decom: the one-process logits and stage outputs}, the CLI's eval on 2
    ranks and on one process)."""
    from slak_tpu_torch.models import create_model
    a = _inputs()
    model = create_model("SLaK_debug", device="cpu", seed=5,
                         kernel_size=(13, 11, 9, 7, 5), num_classes=3)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    path = str(tmp_path_factory.mktemp("tp_cli") / "x.pth")
    torch.save({"model": model.state_dict()}, path)
    with concurrent.futures.ThreadPoolExecutor(len(RANKS) + 1) as pool:
        futs = {d: pool.submit(run_ranks, _tp_worker, d, (a,), "gloo", "cpu",
                               TIMEOUT, TIMEOUT) for d in RANKS}
        fut_cli = pool.submit(_cli_eval, path, [
            "--n_devices", "2", "--dist_backend", "gloo", "--tp_eval",
            "true"])
        ref = {(d, decom): _jax_logits(a, d, decom)
               for d in RANKS for decom in (True, False)}
        one = {}
        for decom in (True, False):
            model = _model(a["sd"][decom], decom)
            x = torch.from_numpy(a["x"]).permute(0, 3, 1, 2).contiguous()
            with torch.no_grad():
                one[decom] = (model(x).numpy(), [
                    s.numpy() for s in model.forward_features(
                        x, return_stages=True)])
        one_cli = _cli_eval(path, [])
        got = {d: f.result() for d, f in futs.items()}
        cli = (fut_cli.result(), one_cli)
    return a, got, ref, one, cli


@pytest.mark.parametrize("decom", [True, False], ids=["decom", "lkb"])
@pytest.mark.parametrize("d", RANKS)
def test_tp_matches_slak_tpu_make_tp_apply(runs, d, decom):
    _, got, ref, _, _ = runs
    for r in range(d):
        np.testing.assert_allclose(got[d][r][decom][0], ref[(d, decom)],
                                   rtol=TOL, atol=TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("decom", [True, False], ids=["decom", "lkb"])
@pytest.mark.parametrize("d", RANKS)
def test_tp_matches_one_process_eval(runs, d, decom):
    _, got, _, one, _ = runs
    for r in range(d):
        np.testing.assert_allclose(got[d][r][decom][0], one[decom][0],
                                   rtol=TOL, atol=TOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("d", RANKS)
def test_tp_padded_lanes_stay_zero(runs, d):
    """The ranks' stage shards, concatenated: the real lanes the
    one-process stage outputs, the padded lanes exactly 0."""
    _, got, _, one, _ = runs
    for decom in (True, False):
        for i, c in enumerate(DIMS):
            full = np.concatenate([got[d][r][decom][1][i] for r in range(d)],
                                  1)
            assert full.shape[1] == -(-c // d) * d
            assert np.all(full[:, c:] == 0.0), (decom, i)
            np.testing.assert_allclose(full[:, :c], one[decom][1][i],
                                       rtol=TOL, atol=TOL)


def test_pad_for_tp_pads_every_channel_axis(runs):
    """Every tensor padded on its channel axes to a multiple of 3 with
    zeros (running variances with ones); the stem's RGB input, the head's
    classes and the scalars untouched."""
    a = runs[0]
    sd = {k: torch.from_numpy(v) for k, v in a["sd"][True].items()}
    padded = pad_for_tp(sd, 3)
    for k, v in sd.items():
        p = padded[k]
        assert p.ndim == v.ndim, k
        if v.ndim == 0:
            assert torch.equal(p, v), k
            continue
        for dim in range(v.ndim):
            if p.shape[dim] != v.shape[dim]:
                assert p.shape[dim] % 3 == 0, (k, dim)
        if k == "head.bias" or k.startswith("downsample_layers.0.0.weight"):
            assert p.shape[1:] == v.shape[1:], k
        fill = 1.0 if k.endswith("running_var") else 0.0
        region = p[tuple(slice(0, s) for s in v.shape)]
        assert torch.equal(region, v), k
        mask = torch.ones_like(p, dtype=torch.bool)
        mask[tuple(slice(0, s) for s in v.shape)] = False
        assert bool((p[mask] == fill).all()), k


def test_cli_tp_eval_matches_one_process_eval(runs):
    tp, one = runs[4]
    assert tp["world"] == 2 and tp["n"] == one["n"] == 9
    assert 0.0 < one["acc1"] < 1.0
    for k in ("loss", "acc1", "acc5"):
        assert tp[k] == pytest.approx(one[k], rel=1e-4, abs=1e-6), k
