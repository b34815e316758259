"""Plain PyTorch version of the moe_gemm kernel: the reference's
``moe_gemm_ref`` (the CPU path, and what the CUDA kernel is held against
on the card), its two passes, which the card's checks also hold the
kernel's two passes against, and :func:`moe_gemm_f64`, the function in
float64 with a bound on the error of a rounded run of it.  Its backward:
:func:`moe_gemm_bwd_ref`, and :func:`moe_bwd_hidden_ref`, what the
backward kernel itself computes."""
import torch
import torch.nn.functional as F


def moe_hidden_ref(x: torch.Tensor, wg: torch.Tensor,
                   wu: torch.Tensor) -> torch.Tensor:
    """The gate/up pass: x (E, C, d); wg/wu (E, d, f) -> h (E, C, f) in
    x's dtype, ``silu(x @ wg) * (x @ wu)`` with both products accumulated
    in float32, rounded once."""
    g = torch.einsum("ecd,edf->ecf", x.float(), wg.float())
    u = torch.einsum("ecd,edf->ecf", x.float(), wu.float())
    return (F.silu(g) * u).to(x.dtype)


def moe_down_ref(h: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """The down pass: h (E, C, f); wd (E, f, d) -> (E, C, d) in h's dtype,
    accumulated in float32."""
    return torch.einsum("ecf,efd->ecd", h.float(), wd.float()).to(h.dtype)


def moe_gemm_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor) -> torch.Tensor:
    """x (E, C, d); wg/wu (E, d, f); wd (E, f, d) -> (E, C, d) in x's
    dtype: ``(silu(x @ wg) * (x @ wu)) @ wd`` per expert, both products
    accumulated in float32 and ``h`` rounded to x's dtype in between."""
    return moe_down_ref(moe_hidden_ref(x, wg, wu), wd)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """float64 inputs are computed in float64, everything else in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def moe_bwd_hidden_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       wd: torch.Tensor, dy: torch.Tensor):
    """What the backward kernel writes: ``(da, db, h)`` (E, C, f) in x's
    dtype, from a = x wg, b = x wu and dh = dy wd^T summed in float32:
    h = silu(a) * b, da = dh * b * silu'(a), db = dh * silu(a), with
    silu'(a) = sigmoid(a) * (1 + a * (1 - sigmoid(a)))."""
    acc = _acc(x.dtype)
    xf, dyf = x.to(acc), dy.to(acc)
    a = torch.einsum("ecd,edf->ecf", xf, wg.to(acc))
    b = torch.einsum("ecd,edf->ecf", xf, wu.to(acc))
    dh = torch.einsum("ecd,efd->ecf", dyf, wd.to(acc))
    sig = torch.sigmoid(a)
    s = F.silu(a)
    da = dh * b * (sig * (1 + a * (1 - sig)))
    return da.to(x.dtype), (dh * s).to(x.dtype), (s * b).to(x.dtype)


def moe_gemm_bwd_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                     wd: torch.Tensor, dy: torch.Tensor):
    """The gradient of :func:`moe_gemm_ref` for the output gradient
    ``dy`` (E, C, d): ``(dx, dwg, dwu, dwd)`` in x's dtype.  da, db and h
    from :func:`moe_bwd_hidden_ref` (rounded to x's dtype as the forward
    rounds h), then dwd = h^T dy, dx = da wg^T + db wu^T, dwg = x^T da and
    dwu = x^T db, each summed in float32 and rounded once."""
    acc = _acc(x.dtype)
    da, db, h = (t.to(acc) for t in moe_bwd_hidden_ref(x, wg, wu, wd, dy))
    xf = x.to(acc)
    dwd = torch.einsum("ecf,ecd->efd", h, dy.to(acc))
    dx = (torch.einsum("ecf,edf->ecd", da, wg.to(acc))
          + torch.einsum("ecf,edf->ecd", db, wu.to(acc)))
    dwg = torch.einsum("ecd,ecf->edf", xf, da)
    dwu = torch.einsum("ecd,ecf->edf", xf, db)
    return tuple(t.to(x.dtype) for t in (dx, dwg, dwu, dwd))


def _gamma(n: int) -> float:
    """The relative error bound of an f32 sum of n exact terms in any
    order, at a unit of 2**-23: twice f32's round-to-nearest unit, so
    that adders which truncate, as tensor cores may, are covered too."""
    t = n * 2.0 ** -23
    return t / (1 - t)


def moe_gemm_f64(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor) -> dict:
    """The function computed exactly from x's values, in float64, and
    for each element how far a run of :func:`moe_gemm_ref`'s computation
    may fall from it, whatever the order of its f32 sums: a dict of
    ``h`` (E, C, f), not rounded, and ``h_bound``; ``out`` (E, C, d) and
    ``out_bound``.  Each bound adds the worst case of each rounding: the
    gate and up sums (products of bf16 values are exact in f32;
    ``_gamma(d)`` of their sums of |terms|), carried through
    ``silu(g) * u`` (|silu'| < 1.1), plus 2**-16 of |h| for the f32
    evaluation of silu and the product; ``h`` rounded once to x's dtype
    (unit roundoff ``u``, 2**-8 for bf16); then the down pass's f32 sum
    (``_gamma(f)``) and the output rounded once.  One rounding step of
    ``h`` in a few of an element's f terms moves it by ``u * |h| * |wd|``
    each, however small the element is, so ``out_bound`` scales with
    ``sum_f |h| * |wd|`` where a relative-and-absolute tolerance cannot.
    One expert at a time, on x's device."""
    u = torch.finfo(x.dtype).eps / 2
    d, f = wg.shape[1], wg.shape[2]
    f64 = dict(dtype=torch.float64, device=x.device)
    E, C = x.shape[:2]
    res = {"h": torch.empty((E, C, f), **f64),
           "h_bound": torch.empty((E, C, f), **f64),
           "out": torch.empty(x.shape, **f64),
           "out_bound": torch.empty(x.shape, **f64)}
    for e in range(E):
        xe, ge, ue, de = (t[e].double() for t in (x, wg, wu, wd))
        ax = xe.abs()
        g, up = xe @ ge, xe @ ue
        eg, eu = _gamma(d) * (ax @ ge.abs()), _gamma(d) * (ax @ ue.abs())
        s = F.silu(g)
        h = s * up
        dh = 1.1 * eg * (up.abs() + eu) + s.abs() * eu       # f32 h - h
        dh += 2.0 ** -16 * (h.abs() + dh)
        dh = u * h.abs() + (1 + u) * dh                      # rounded h - h
        ad = de.abs()
        out = h @ de
        rest = dh @ ad + _gamma(f) * ((h.abs() + dh) @ ad)
        res["h"][e], res["h_bound"][e], res["out"][e] = h, dh, out
        res["out_bound"][e] = (1 + u) * rest + u * out.abs()
    return res


def bound_ratio(got: torch.Tensor, want: torch.Tensor,
                bound: torch.Tensor) -> float:
    """The largest ``|got - want| / bound``: within the bound iff at most
    1 (inf where the bound is 0 and the error is not)."""
    diff = (got.double() - want).abs()
    if bool(((bound == 0) & (diff > 0)).any()):
        return float("inf")
    return float((diff / bound.clamp_min(1e-300)).max())
