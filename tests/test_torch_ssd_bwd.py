"""The gradients of the ``ssd_scan`` kernel and of the split-row rmsnorm,
held against the JAX package on the CPU.

* ``ops.ssd_scan``'s gradients (its ``torch.autograd.Function``, whose
  backward on the CPU is the plain ``kernels/ref.py::ssd_scan_bwd_ref``)
  against ``jax.vjp`` of the reference's ``_ssd_chunked`` where the chunk
  divides S: with and without an initial state ``h0`` and a cotangent at
  the final state (``dh_final``), B and C given as strided column views
  of one wider tensor, as the mixer hands them in;
* the Mamba2 mixer (port against ``repro.models.ssm.mamba2_mixer``) where
  the chunk does not divide S, the reference's exact branch: every
  parameter's, the input's and the carried state's gradients;
* the plain backward itself against ``torch.autograd`` of the plain
  forward (a step-by-step backward checked against a second route);
* the split-row norm's backward (``ops.rmsnorm_split``, two ranks' slices
  of each row, each slice's Function given a sum over the "ranks" that
  adds the other slice's part) against ``jax.grad`` of the whole-row
  ``repro.models.layers.rmsnorm``, the slices put back together.

Tolerance 1e-5 of each gradient's largest |value| (fp32; the orders of
summation differ).  Inputs come from numpy seeds.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.registry import get_smoke_model as jax_smoke  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.registry import get_smoke_model as torch_smoke  # noqa: E402

TOL = 1e-5          # of each gradient's largest |value|
ARCH = "zamba2-2.7b"


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    top = max(np.abs(want).max(), 1e-30)
    assert err <= TOL * top, (what, err, top)


def _inputs(B, S, H, dh, ds, seed, with_h0, with_dh):
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    wide = (rng.standard_normal((B, S, 3 * ds)) * 0.3).astype(np.float32)
    ld = (-np.abs(rng.standard_normal((B, S, H))) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, H, dh, ds)).astype(np.float32) if with_h0 else None
    dy = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    dhf = rng.standard_normal((B, H, dh, ds)).astype(np.float32) if with_dh else None
    return xb, wide, ld, h0, dy, dhf


# ---------------------------------------------------------------------------
# ssd_scan: the Function against jax.vjp of the reference's chunked SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0,with_dh", [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize("B,S,H,dh,ds,Q", [(2, 32, 3, 8, 16, 16),
                                           (1, 48, 2, 16, 8, 48),
                                           (2, 16, 4, 32, 16, 4)])
def test_ssd_scan_gradients_match_jax_vjp(B, S, H, dh, ds, Q, with_h0, with_dh):
    """Chunk dividing S: xb, B, C, the log decays and h0 (given) against
    ``jax.vjp(_ssd_chunked)`` with cotangents dy and (given) dh_final; B
    and C are columns ``[ds, 2 ds)`` and ``[2 ds, 3 ds)`` of one
    ``[B, S, 3 ds]`` tensor, so their gradients land in that tensor."""
    xb, wide, ld, h0, dy, dhf = _inputs(B, S, H, dh, ds, S * H + dh, with_h0,
                                        with_dh)
    Bm, Cm = wide[..., ds:2 * ds], wide[..., 2 * ds:]

    def jfn(x, b, c, l, *h):
        return jssm._ssd_chunked(x, b, c, l, Q, h[0] if h else None)

    prim = [jnp.asarray(a) for a in (xb, Bm, Cm, ld)] + (
        [jnp.asarray(h0)] if with_h0 else [])
    cot_h = jnp.asarray(dhf) if with_dh else jnp.zeros((B, H, dh, ds), jnp.float32)

    @jax.jit
    def forward_and_vjp(*a):
        out, vjp = jax.vjp(jfn, *a)
        return out, vjp((jnp.asarray(dy), cot_h))

    (jy, jh), want = forward_and_vjp(*prim)

    tw = _t(wide).requires_grad_(True)
    tx, tl = _t(xb).requires_grad_(True), _t(ld).requires_grad_(True)
    th = _t(h0).requires_grad_(True) if with_h0 else None
    tb, tc = tw[..., ds:2 * ds], tw[..., 2 * ds:]
    assert not tb.is_contiguous() and tb.stride(-1) == 1
    y, h = ops.ssd_scan(tx, tb, tc, tl, Q, th)
    assert y.grad_fn is not None and type(y.grad_fn).__name__.startswith("_SsdScan")
    _close(y.detach(), jy, "y")
    _close(h.detach(), jh, "h_final")
    outs, cots = [y], [_t(dy)]
    if with_dh:
        outs.append(h)
        cots.append(_t(dhf))
    ins = [tx, tw, tl] + ([th] if with_h0 else [])
    got = torch.autograd.grad(outs, ins, cots)
    _close(got[0], want[0], "dxb")
    gw = got[1].numpy()
    assert not gw[..., :ds].any()                 # the unread columns
    _close(gw[..., ds:2 * ds], want[1], "dB")
    _close(gw[..., 2 * ds:], want[2], "dC")
    _close(got[2], want[3], "dlog_decay")
    if with_h0:
        _close(got[3], want[4], "dh0")


@pytest.mark.parametrize("B,S,H,dh,ds,with_h0,with_dh", [
    (2, 9, 3, 8, 4, True, True), (1, 1, 2, 4, 4, False, True),
    (2, 13, 2, 8, 8, False, False)])
def test_ssd_plain_backward_matches_autograd(B, S, H, dh, ds, with_h0, with_dh):
    """``ssd_scan_bwd_ref`` (step by step) against ``torch.autograd`` of
    the sequential plain forward ``ssd_scan_ref``, S = 1 included."""
    xb, wide, ld, h0, dy, dhf = _inputs(B, S, H, dh, ds, 5 * S + H, with_h0,
                                        with_dh)
    Bm, Cm = wide[..., :ds], wide[..., ds:2 * ds]
    got = ref.ssd_scan_bwd_ref(_t(xb), _t(Bm), _t(Cm), _t(ld), _t(dy), _t(h0),
                               _t(dhf))
    ins = [_t(a).requires_grad_(True) for a in (xb, Bm, Cm, ld)] + (
        [_t(h0).requires_grad_(True)] if with_h0 else [])
    y, h = ref.ssd_scan_ref(*ins[:4], ins[4] if with_h0 else None)
    loss = (y * _t(dy)).sum() + ((h * _t(dhf)).sum() if with_dh else 0)
    want = torch.autograd.grad(loss, ins)
    for name, g, w in zip(("dxb", "dB", "dC", "dld", "dh0"), got, want):
        _close(g, w, name)
    assert (got[4] is None) == (not with_h0)


# ---------------------------------------------------------------------------
# the Mamba2 mixer's gradients on the reference's exact branch
# ---------------------------------------------------------------------------

def _mixer_params(cfg_t, seed):
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in
              ssm.init_mamba2_params(None, cfg_t).items()}
    p = {k: (rng.standard_normal(s) * (0.5 if k in ("dt_bias", "a_log")
                                       else 1 / np.sqrt(s[0]))).astype(np.float32)
         for k, s in shapes.items()}
    p["d_skip"] = (1 + 0.1 * rng.standard_normal(shapes["d_skip"])).astype(np.float32)
    p["norm"] = (1 + 0.1 * rng.standard_normal(shapes["norm"])).astype(np.float32)
    return p


@pytest.mark.parametrize("S,with_state", [(20, True), (20, False), (32, True)])
def test_mamba2_mixer_gradients_match_jax(S, with_state):
    """The smoke zamba mixer (chunk 16): S = 20 runs the reference's exact
    branch and S = 32 its chunked one; the loss reads the output and the
    new recurrent state, so every parameter, the input, the carried ``h``
    and the conv state take a gradient, against ``jax.vjp``."""
    tcfg = torch_smoke(ARCH, device="cpu").cfg
    jcfg = jax_smoke(ARCH).cfg
    p = _mixer_params(tcfg, 11)
    rng = np.random.default_rng(S)
    x = (rng.standard_normal((2, S, jcfg.d_model)) * 0.5).astype(np.float32)
    state = None
    if with_state:
        state = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
                 for k, s in ssm.mamba2_state_shape(tcfg, 2).items()}
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dh = rng.standard_normal(ssm.mamba2_state_shape(tcfg, 2)["h"]).astype(np.float32)

    def jfn(pp, xx, st):
        y, new = jssm.mamba2_mixer(pp, xx, jcfg, st)
        return jnp.sum(y * dy) + jnp.sum(new["h"] * dh)

    jst = None if state is None else {k: jnp.asarray(v) for k, v in state.items()}
    want_p, want_x, want_st = jax.jit(jax.grad(jfn, argnums=(0, 1, 2)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jst)

    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    tst = None if state is None else {k: _t(v).requires_grad_(True)
                                      for k, v in state.items()}
    y, new = ssm.mamba2_mixer(tp, tx, tcfg, tst)
    loss = (y * _t(dy)).sum() + (new["h"] * _t(dh)).sum()
    leaves = list(tp.values()) + [tx] + ([] if tst is None else list(tst.values()))
    got = dict(zip(list(tp) + ["x"] + ([] if tst is None else
                                       [f"state.{k}" for k in tst]),
                   torch.autograd.grad(loss, leaves)))
    for k in p:
        _close(got[k], want_p[k], k)
    _close(got["x"], want_x, "x")
    if tst is not None:
        for k in tst:
            _close(got[f"state.{k}"], want_st[k], f"state.{k}")


# ---------------------------------------------------------------------------
# the split-row norm's backward
# ---------------------------------------------------------------------------

class _TwoRanks:
    """A stand-in for the sum over two ranks in one process: rank
    ``mine``'s Function calls ``reduce`` on its forward sums, then on its
    backward dots; each call adds the other slice's part (its plain
    version), as the all_reduce would."""

    def __init__(self, xs, scales, dys, mine):
        self.xs, self.scales, self.dys, self.mine = xs, scales, dys, mine
        self.calls = 0

    def __call__(self, buf):
        other = 1 - self.mine
        self.calls += 1
        if self.calls == 1:
            part = ref.rmsnorm_sumsq_ref(self.xs[other])
        else:
            part = ref.rmsnorm_split_dot_ref(self.xs[other], self.scales[other],
                                             self.dys[other])
        return buf + part


@pytest.mark.parametrize("shape,cut", [((2, 5, 64), 32), ((7, 48), 16),
                                       ((3, 4, 96), 48), ((4, 64), 0),
                                       ((3, 2, 32), 32)])
def test_split_rmsnorm_gradients_match_jax_grad(shape, cut):
    """Rows of ``shape[-1]`` cut at ``cut`` into two ranks' slices; each
    slice's ``ops.rmsnorm_split`` output and its dx and dscale (two
    ``reduce`` calls: the sums forward, the dots backward) against
    ``jax.grad`` of the whole-row norm with cotangent dy; the plain
    second launch's rstd is the forward's.  A cut at either end leaves
    one rank an empty slice (a rank without a head): its sums and dots
    are zeros, which the wrappers return on every device."""
    rng = np.random.default_rng(shape[-1] + cut)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    eps, d = 1e-5, shape[-1]
    want_y, vjp = jax.vjp(lambda a, s: jlayers.rmsnorm(a, s, eps),
                          jnp.asarray(x), jnp.asarray(scale))
    want_dx, want_ds = vjp(jnp.asarray(dy))

    cuts = [slice(0, cut), slice(cut, d)]
    xs = [_t(x[..., c]) for c in cuts]
    scales = [_t(scale[c]) for c in cuts]
    dys = [_t(dy[..., c]) for c in cuts]
    ys, dxs, dss = [], [], []
    for r in range(2):
        tx = xs[r].clone().requires_grad_(True)
        ts = scales[r].clone().requires_grad_(True)
        reduce = _TwoRanks(xs, scales, dys, r)
        y = ops.rmsnorm_split(tx, ts, eps, d, reduce)
        gx, gs = torch.autograd.grad(y, (tx, ts), dys[r])
        assert reduce.calls == 2
        ys.append(y.detach())
        dxs.append(gx)
        dss.append(gs)
    _close(torch.cat(ys, dim=-1), want_y, "y")
    _close(torch.cat(dxs, dim=-1), want_dx, "dx")
    _close(torch.cat(dss), want_ds, "dscale")


def test_split_rmsnorm_refuses_bf16_gradients_off_the_cpu():
    """A bf16 split-row norm that needs a gradient raises on a card
    (``meta`` stands in for one here), naming ROADMAP Queue 2 item 7; in
    fp32 it carries the gradient, both backward launches reported."""
    m = dict(device="meta")
    x = torch.zeros((2, 3, 16), dtype=torch.bfloat16, **m, requires_grad=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        ops.rmsnorm_split(x, torch.ones(16, dtype=torch.bfloat16, **m), 1e-5, 32,
                          lambda t: t)
    xf = torch.zeros((2, 3, 16), **m, requires_grad=True)
    y = ops.rmsnorm_split(xf, torch.ones(16, **m), 1e-5, 32, lambda t: t)
    assert y.requires_grad and y.shape == xf.shape
