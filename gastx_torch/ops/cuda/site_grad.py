"""The plain sites' row-wide products in the train step, at their tiers.

The JAX package trains under ``jax.default_matmul_precision`` with every
XLA site at its tier (``gastx/models/gastnet.py:89-90``), and JAX's
transpose rules pass a dot's or a conv's precision on unchanged to both
transposed products (``jax/_src/lax/lax.py``, ``_dot_general_transpose_lhs``
/ ``_rhs``, and the conv's), so on the TPU a site's ``dA = G W^T`` and
``dW = A^T G`` run at the forward's tier too. Autograd through the tiered
products cannot give that (the bf16 rounding has no gradient, and the
cotangent would never be split), and the kernels have no backward.
:class:`SiteGemm` is the autograd Function of one site's product:

  * forward: the product alone through ``kernels.site_gemm`` at the tier
    (``gemm_tc``, or ``gemm_smallk`` by its shape rule), no epilogue: the
    caller applies the train BN (batch statistics) and ReLU in torch;
  * backward, the input gradient: ``kernels.gemm_epilogue`` at the same
    tier. A 1x1 or a concatenation (:class:`Rows`): ``G W^T``, one product
    whose columns are the pieces' gradients. A conv (:class:`Conv`),
    dilated or causal: the taps reversed over G padded by (fw-1)*d frames
    a side, through the forward's row map; strided: one product of G with
    the taps' ``W_k^T`` side by side, reshaped onto the frames it read
    (the frames the forward cut off get zero by autograd of the cut);
    more than three taps chain launches of three, as the forward does;
  * backward, the weight gradient: ``kernels.gemm_wgrad`` over the
    forward's row map (the conv's taps as its pieces, up to three a
    launch).

It saves what autograd would save, the input activation and W. Inside its
forward and backward grad mode is off, so the wrappers' ``check_no_grad``
holds as it is; under ``torch.no_grad()`` (the eval forward's
``local_sem``, whose product has no epilogue) it is its forward alone.
With ``plain`` every product is its wrapper's plain version (on the CPU
the wrappers choose it by themselves). On the CPU the model resolves
every site to ``"highest"`` (``ops.precision``), which never reaches this
module.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from gastx_torch.ops.cuda import kernels as K

# The pieces one GEMM launch takes.
MAX_PIECES = 3


def _gemm(site, pieces, m, **kw) -> torch.Tensor:
    gemm = K.gemm_epilogue_plain if site.plain else K.gemm_epilogue
    K.count_site_grad(site.op, f"dA {site.tier}", pieces[0][0])
    return gemm(pieces, m, tier=site.tier, **kw)


def _wgrad(site, pieces, g, m, **kw) -> torch.Tensor:
    wgrad = K.gemm_wgrad_plain if site.plain else K.gemm_wgrad
    K.count_site_grad(site.op, f"dW {site.tier}", g)
    return wgrad(pieces, g, m, tier=site.tier, **kw)


def _chain(gemm, pieces, m, **kw) -> torch.Tensor:
    """``sum_p`` over any number of pieces: launches of up to three, each
    adding the last one's output as its residual."""
    y = None
    for i in range(0, len(pieces), MAX_PIECES):
        y = gemm(pieces[i:i + MAX_PIECES], m, res=y, **kw)
    return y


@dataclasses.dataclass(frozen=True)
class Rows:
    """``sum_p A_p @ W[rows of p]``: each A_p (m, K_p) its own tensor (a 1x1
    conv is one piece, a concatenation's parts are several), W (sum K_p,
    N) the stacked weights."""
    op: str
    tier: str
    plain: bool
    m: int
    ks: Tuple[int, ...]

    def forward(self, w, a):
        rows, pieces = 0, []
        for x, k in zip(a, self.ks):
            pieces.append((x, w[rows:rows + k], 0))
            rows += k
        return K.site_gemm(self.op, pieces, self.m, self.tier, self.plain)

    def grad_a(self, g, w, a):
        da = _gemm(self, [(g, w.t().contiguous(), 0)], self.m)
        return torch.split(da, list(self.ks), dim=1)

    def grad_w(self, g, a):
        return _wgrad(self, [(x, 0) for x in a], g, self.m)


@dataclasses.dataclass(frozen=True)
class Conv:
    """A valid temporal conv's taps over the (B*T*J, C) input rows, W (fw,
    C, N): output frame t sums tap k of input frame t*stride + k*dilation.
    Strided (stride > 1) the input is cut to its first t_out*stride
    frames, and the taps must lie within the stride."""
    op: str
    tier: str
    plain: bool
    b: int
    t_in: int
    t_out: int
    j: int
    fw: int
    dilation: int
    stride: int

    @property
    def m(self) -> int:
        return self.b * self.t_out * self.j

    def row_map(self) -> dict:
        if self.stride == 1:
            return dict(s_out=self.t_out * self.j, a_s_in=self.t_in * self.j)
        return dict(s_out=self.j, a_s_in=self.stride * self.j)

    def taps(self, x):
        return [(x, k * self.dilation * self.j) for k in range(self.fw)]

    def forward(self, w, a, **epilogue):
        """The taps' product; ``epilogue`` (``gemm_epilogue``'s scale,
        shift and relu: the eval forward's) in its one launch, which takes
        at most three taps; more chain launches of three."""
        pieces = [(x, w[k], off) for k, (x, off) in
                  enumerate(self.taps(a[0]))]
        if len(pieces) <= MAX_PIECES:
            return K.site_gemm(self.op, pieces, self.m, self.tier,
                               self.plain, **self.row_map(), **epilogue)
        return _chain(lambda p, m, **kw: K.site_gemm(
            self.op, p, m, self.tier, self.plain, **kw), pieces, self.m,
            **self.row_map())

    def grad_a(self, g, w, a):
        fw, c, n = w.shape
        j, d = self.j, self.dilation
        if self.stride == 1:
            pad = (fw - 1) * d
            gp = F.pad(g.view(self.b, self.t_out, j * n), (0, 0, pad, pad))
            gp = gp.reshape(-1, n)
            pieces = [(gp, w[fw - 1 - k].t().contiguous(), k * d * j)
                      for k in range(fw)]
            return (_chain(lambda p, m, **kw: _gemm(self, p, m, **kw),
                           pieces, self.b * self.t_in * j,
                           s_out=self.t_in * j,
                           a_s_in=(self.t_out + 2 * pad) * j),)
        wcat = w.permute(2, 0, 1).reshape(n, fw * c).contiguous()
        dx = _gemm(self, [(g, wcat, 0)], self.m)
        dx = dx.view(self.b, self.t_out, j, fw, c).transpose(2, 3)
        if d == 1 and fw == self.stride:
            return (dx.reshape(-1, c),)
        full = dx.new_zeros(self.b, self.t_out, self.stride, j, c)
        full[:, :, 0:(fw - 1) * d + 1:d] = dx
        return (full.reshape(-1, c),)

    def grad_w(self, g, a):
        taps = self.taps(a[0])
        return torch.cat([
            _wgrad(self, taps[i:i + MAX_PIECES], g, self.m, **self.row_map())
            for i in range(0, len(taps), MAX_PIECES)])


class SiteGemm(torch.autograd.Function):
    """One plain site's product (a :class:`Rows` or :class:`Conv` spec) at
    its tier, with its input and weight gradients at the same tier (module
    docstring). ``SiteGemm.apply(site, w, *a)``: W and the activations as
    the spec takes them, float32 and contiguous."""

    @staticmethod
    def forward(ctx, site, w, *a):
        ctx.site = site
        ctx.save_for_backward(w, *a)
        return site.forward(w, a)

    @staticmethod
    def backward(ctx, g):
        w, *a = ctx.saved_tensors
        site, g = ctx.site, g.contiguous()
        need_w, need_a = ctx.needs_input_grad[1], ctx.needs_input_grad[2:]
        dw = site.grad_w(g, a).view(w.shape) if need_w else None
        da = site.grad_a(g, w, a) if any(need_a) else [None] * len(a)
        return (None, dw, *(d if need else None
                            for d, need in zip(da, need_a)))


def grad_needed(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a product of ``tensors``: grad mode on and
    one of them requires a gradient (the train step)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def site_product(op: str, xs: Sequence[torch.Tensor], w: torch.Tensor,
                 tier: str, plain: bool = False) -> torch.Tensor:
    """``cat(xs, -1) @ w`` of the plain site ``op`` at ``tier`` through
    :class:`SiteGemm` (the concatenation never made): ``xs`` (..., K_p)
    with one leading shape, ``w`` (sum K_p, N). Returns (..., N)."""
    if not 1 <= len(xs) <= MAX_PIECES:
        raise ValueError(f"a site product takes 1 to {MAX_PIECES} pieces, "
                         f"got {len(xs)}")
    lead = xs[0].shape[:-1]
    rows = [x.reshape(-1, x.shape[-1]).contiguous() for x in xs]
    site = Rows(op, tier, plain, rows[0].shape[0],
                tuple(x.shape[1] for x in rows))
    y = SiteGemm.apply(site, w.to(torch.float32).contiguous(), *rows)
    return y.reshape(*lead, w.shape[1])


def conv_site(op: str, x: torch.Tensor, fw: int, dilation: int,
              stride: int, t_out: int, tier: str, plain: bool = False
              ) -> Tuple[Conv, torch.Tensor]:
    """The :class:`Conv` of a valid temporal conv
    (``ops.temporal.temporal_conv``'s) of the plain site ``op`` at
    ``tier`` on ``x`` (B, T, J, C), ``fw`` taps, and the (rows, C) input
    rows its tap row map reads: all of ``x`` (stride 1: frame t + k *
    dilation of each sequence) or, strided, ``x`` cut to its first t_out *
    stride frames (frame t * stride + k * dilation of one output frame's
    sequence; the taps must lie within the stride). The eval forward's
    tiered conv (its epilogue in the launch) runs the same spec's
    forward."""
    b, t, j, c = x.shape
    if stride > 1:
        if (fw - 1) * dilation >= stride:
            raise ValueError(f"a strided conv whose taps reach past its "
                             f"stride ({fw} taps at dilation {dilation}, "
                             f"stride {stride}) has no tap row map")
        x = x[:, :t_out * stride]
        t = t_out * stride
    return (Conv(op, tier, plain, b, t, t_out, j, fw, dilation, stride),
            x.reshape(-1, c).contiguous())


def site_conv(op: str, x: torch.Tensor, w: torch.Tensor, dilation: int,
              stride: int, t_out: int, tier: str, plain: bool = False
              ) -> torch.Tensor:
    """That conv (:func:`conv_site`) through :class:`SiteGemm`, ``w`` (fw,
    C, N). Returns (B, t_out, J, N)."""
    site, rows = conv_site(op, x, w.shape[0], dilation, stride, t_out, tier,
                           plain)
    y = SiteGemm.apply(site, w.to(torch.float32).contiguous(), rows)
    return y.reshape(x.shape[0], t_out, x.shape[2], w.shape[2])
