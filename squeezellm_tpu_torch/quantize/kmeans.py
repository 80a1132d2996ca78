"""Sensitivity-weighted 1-D k-means for non-uniform quantization (NUQ), in
PyTorch on the device the caller's tensors lie on.

The port of the JAX package's ``quantize/kmeans.py``. ``fit_module_luts``
has three solvers:

* ``native`` (the default, as ``auto`` is in the JAX package): the JAX
  package's sorted-Lloyd C++ solver, a copy of which the port keeps in
  ``csrc/host/nuq_kmeans.cpp`` and builds with the host's ``g++`` at first
  use (``_build.host_lib``). It runs on the host with OpenMP; its codebooks
  and codes equal the JAX package's default bit for bit.
* ``sklearn``: scikit-learn's ``KMeans`` a channel at a time on the host,
  as the reference fits its codebooks (``nuq.py``) and as the JAX
  package's ``sklearn`` mode does, with the same arguments; imported at
  first use, so the package loads without scikit-learn.
* ``batched``: ``weighted_kmeans_batched``, on the tensors' device, the
  same function as the JAX package's ``batched`` solver (which
  ``fit_structured_luts`` also uses for its init). It and
  ``fit_structured_luts`` and ``structured_decomposition`` compute, in f64:

* seeded weighted k-means++ init, one ``np.random.default_rng(seed)`` per
  chunk of 256 channels (so a last partial chunk draws another sequence);
  the draws are taken with numpy on the host and moved to the device;
* Lloyd iterations, at most ``max_iter``, stopping per chunk when every
  centroid moved less than ``tol`` or no objective improved by more than
  ``tol * max(obj, 1)``;
* centroids sorted ascending at the end, codes re-assigned to them.

What differs is how an iteration is computed. Nearest-centroid assignment
in one dimension cuts a channel's sorted values into intervals at the
midpoints between sorted centroids, so each channel is sorted once and
every cluster's weighted sums are differences of prefix sums at the
interval ends: an iteration costs O(k log N) per channel instead of the
O(N k) distance tensor, which is what makes a 7B model's modules fit into
seconds on the card. Sums are taken in another order than numpy's, so
centroids agree to ~1e-15 relative and a code can differ only where a
value sits on a midpoint to rounding. A centroid equal to another one
(possible only when a channel has fewer distinct weighted values than k)
takes no values, as argmin's first-index rule gives them to the lower
index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

CHUNK = 256  # channels per k-means++ draw sequence and stopping decision
F64 = torch.float64


def _draws(C: int, k: int, seed: int, chunk: int) -> np.ndarray:
    """(k, C) uniforms: row j holds the j-th ``rng.random((c, 1))`` draw of
    each chunk's fresh generator, as the JAX package's solver takes them."""
    out = np.empty((k, C))
    for c0 in range(0, C, chunk):
        c = min(chunk, C - c0)
        rng = np.random.default_rng(seed)
        for j in range(k):
            out[j, c0: c0 + c] = rng.random((c, 1))[:, 0]
    return out


def _kmeanspp_init(x, w, k, r):
    """Weighted k-means++ on (C, N) rows with the draws r (k, C)."""
    C, N = x.shape
    rows = torch.arange(C, device=x.device)
    cent = torch.empty(C, k, dtype=F64, device=x.device)
    cdf = torch.cumsum(w / w.sum(1, keepdim=True), 1)
    first = (cdf < r[0, :, None]).sum(1).clamp(0, N - 1)
    cent[:, 0] = x[rows, first]
    d2 = (x - cent[:, :1]) ** 2
    for j in range(1, k):
        score = d2 * w
        tot = score.sum(1, keepdim=True)
        tot = torch.where(tot <= 0, 1.0, tot)
        cdf = torch.cumsum(score / tot, 1)
        idx = (cdf < r[j, :, None]).sum(1).clamp(0, N - 1)
        cent[:, j] = x[rows, idx]
        d2 = torch.minimum(d2, (x - cent[:, j: j + 1]) ** 2)
    return cent


class _Sorted:
    """A module's channels sorted once, with exclusive prefix sums of the
    weights and their first and second moments along each sorted row."""

    def __init__(self, x, w):
        xs, order = torch.sort(x, dim=1, stable=True)
        ws = w.gather(1, order)
        self.xs = xs

        def prefix(v):
            return torch.nn.functional.pad(torch.cumsum(v, 1), (1, 0))

        self.pw = prefix(ws)
        self.pwx = prefix(ws * xs)
        self.pwxx = prefix(ws * xs * xs)

    def sums(self, cent):
        """Per centroid (original order): sums of w, w*x and w*x*x over the
        values nearest to it. A sorted centroid's interval ends after the
        last sorted value at or below its upper midpoint."""
        perm, mids = _sorted_mids(cent)
        ends = torch.searchsorted(self.xs, mids, right=True)
        ends = torch.cat([ends, torch.full_like(ends[:, :1],
                                                self.xs.shape[1])], 1)
        starts = torch.nn.functional.pad(ends[:, :-1], (1, 0))
        out = []
        for p in (self.pw, self.pwx, self.pwxx):
            seg = p.gather(1, ends) - p.gather(1, starts)
            out.append(torch.empty_like(seg).scatter_(1, perm, seg))
        return out


def _sorted_mids(cent):
    """For centroids (C, k) in any order: the sorted order ``perm`` (stable:
    the lower index first among equals) and the k - 1 midpoints between
    sorted neighbours (C, k - 1). A centroid equal to the next one takes no
    values (argmin gives them to the lower index), so its upper midpoint is
    the next distinct centroid's."""
    s, perm = torch.sort(cent, dim=1, stable=True)
    mids = (s[:, :-1] + s[:, 1:]) / 2
    mids = torch.where(s[:, :-1] == s[:, 1:], torch.inf, mids)
    mids = torch.flip(torch.cummin(torch.flip(mids, [1]), 1).values, [1])
    return perm, mids.contiguous()


def labels(cent: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Codes of the values x (C, N) against centroids (C, k): the nearest
    one, the first index on a tie, as uint8. A value belongs to the sorted
    centroid whose number is the count of midpoints below it."""
    perm, mids = _sorted_mids(cent)
    pos = torch.searchsorted(mids, x.contiguous(), right=False)
    return perm.gather(1, pos).to(torch.uint8)


def _all_per_chunk(flags: torch.Tensor, chunk: int) -> torch.Tensor:
    """(C,) bools -> (ceil(C / chunk),): whether every row of a chunk is
    True."""
    pad = -flags.shape[0] % chunk
    return torch.nn.functional.pad(flags, (0, pad),
                                   value=True).view(-1, chunk).all(1)


def _lloyd(sx: _Sorted, cent, chunk, max_iter, tol):
    """Lloyd iterations on every chunk at once, each chunk stopping on its
    own test; returns the centroids (C, k), unsorted."""
    C = cent.shape[0]
    rows = torch.arange(C, device=cent.device)
    active = torch.ones(-(-C // chunk), dtype=torch.bool, device=cent.device)
    prev_obj = torch.full((C,), torch.inf, dtype=F64, device=cent.device)
    for _ in range(max_iter):
        sw, swx, swxx = sx.sums(cent)
        new_cent = torch.where(sw > 0, swx / torch.clamp(sw, min=1e-30), cent)
        # sum of w * (x - c)^2 over each cluster, c the current centroid
        obj = (swxx - 2 * cent * swx + cent * cent * sw).sum(1)
        moved = (new_cent - cent).abs().max(1).values
        cent = torch.where(active[rows // chunk, None], new_cent, cent)
        stop = (_all_per_chunk(moved < tol, chunk)
                | _all_per_chunk(prev_obj - obj
                                 <= tol * torch.clamp(obj, min=1.0), chunk))
        active = active & ~stop
        prev_obj = obj
        if not bool(active.any()):
            break
    return cent


def weighted_kmeans_batched(
    values: torch.Tensor,
    weights: Optional[torch.Tensor],
    k: int,
    max_iter: int = 50,
    seed: int = 0,
    tol: float = 1e-6,
    chunk: int = CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted 1-D Lloyd over a batch of channels.

    values: (C, N), one row per output channel; weights: (C, N) nonneg
    sample weights or None (uniform); rows summing to zero fall back to
    uniform. Returns (centroids (C, k) f32 sorted ascending, labels (C, N)
    uint8), on values' device."""
    x = values.to(F64)
    C, N = x.shape
    if weights is None:
        w = torch.ones_like(x)
    else:
        w = weights.to(F64)
        zero_rows = w.sum(1) <= 0
        w = torch.where(zero_rows[:, None], 1.0, w)
    r = torch.from_numpy(_draws(C, k, seed, chunk)).to(x.device)
    cent = _kmeanspp_init(x, w, k, r)
    cent = _lloyd(_Sorted(x, w), cent, chunk, max_iter, tol)
    cent_sorted = torch.sort(cent, dim=1).values
    return cent_sorted.to(torch.float32), labels(cent_sorted, x)


def weighted_kmeans_native(values: torch.Tensor, weights: torch.Tensor,
                           k: int, max_iter: int = 50, seed: int = 0,
                           tol: float = 1e-8
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host's sorted-Lloyd solver (``csrc/host/nuq_kmeans.cpp``) on
    (C, N) values and nonneg weights, both taken as f32 (the JAX package's
    ``_native.weighted_kmeans_batched``). Returns (centroids (C, k) f32
    sorted ascending, labels (C, N) uint8) on values' device."""
    from squeezellm_tpu_torch import _build

    try:
        lib = _build.host_lib()
    except (RuntimeError, OSError) as e:
        raise RuntimeError(
            f"the native k-means solver could not be built or loaded ({e}); "
            "pass method=\"batched\" to fit on the device instead") from e
    x = np.ascontiguousarray(values.detach().cpu().numpy(), dtype=np.float32)
    w = np.ascontiguousarray(weights.detach().cpu().numpy(), dtype=np.float32)
    C, N = x.shape
    cents = np.empty((C, k), dtype=np.float32)
    labels_out = np.empty((C, N), dtype=np.uint8)
    lib.nuq_weighted_kmeans_batched(
        x.ctypes.data, w.ctypes.data, C, N, k, max_iter, seed, tol,
        cents.ctypes.data, labels_out.ctypes.data)
    return (torch.from_numpy(cents).to(values.device),
            torch.from_numpy(labels_out).to(values.device))


def _sample_weights(weight, gradient):
    """grad^2 masked at zeroed slots (reference nuq.py:169-176), uniform
    over the nonzero slots without gradients, all-zero rows uniform."""
    mask = (weight != 0).to(F64)
    sw = mask if gradient is None else gradient.to(F64) * mask
    zero_rows = sw.sum(1) <= 0
    return torch.where(zero_rows[:, None], 1.0, sw)


def weighted_kmeans_sklearn(values: torch.Tensor, weights: torch.Tensor,
                            k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """scikit-learn's ``KMeans(n_clusters=k, random_state=0,
    n_init="auto", max_iter=50)`` on each row of (C, N) values (taken as
    f32) with its sample weights (f64), centroids then sorted ascending and
    labels remapped to the sorted order. Returns (centroids (C, k) f32,
    labels (C, N) uint8) on values' device."""
    try:
        from sklearn.cluster import KMeans
    except ImportError as e:
        raise ImportError(
            "method=\"sklearn\" needs the scikit-learn package (sklearn); "
            "the default method=\"auto\" does not") from e
    x = values.detach().cpu().numpy().astype(np.float32)
    w = weights.detach().cpu().numpy().astype(np.float64)
    cents, labs = [], []
    for row, sw in zip(x, w):
        km = KMeans(n_clusters=k, random_state=0, n_init="auto",
                    max_iter=50).fit(row.reshape(-1, 1), sample_weight=sw)
        cents.append(km.cluster_centers_.reshape(-1))
        labs.append(km.labels_.astype(np.uint8))
    lut = np.stack(cents).astype(np.float32)
    order = np.argsort(lut, axis=1)
    inv = np.empty_like(order)
    np.put_along_axis(inv, order, np.arange(k)[None].repeat(len(lut), 0), 1)
    labels_out = np.take_along_axis(inv, np.stack(labs).astype(np.int64), 1)
    return (torch.from_numpy(np.take_along_axis(lut, order, 1)).to(
        values.device),
            torch.from_numpy(labels_out.astype(np.uint8)).to(values.device))


def fit_module_luts(weight: torch.Tensor, gradient: Optional[torch.Tensor],
                    bits: int, method: str = "auto",
                    seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel codebooks for one module.

    weight: (out, in) with outlier slots zeroed; gradient: (out, in) grad^2
    or None. method: 'auto' (= 'native', the JAX package's default solver,
    on the host), 'batched' (on the weight's device) or 'sklearn' (on the
    host, a channel at a time). The sample weights
    are grad^2 masked at zeroed slots, as f32 for the native solver as the
    JAX package hands them over. Returns (lut (out, 2**bits) f32 sorted,
    labels (out, in) uint8)."""
    if method not in ("auto", "native", "batched", "sklearn"):
        raise ValueError(f"unknown method {method!r}: the port has 'auto' "
                         "(= 'native'), 'batched' and 'sklearn'")
    weight = weight.to(torch.float32)
    sw = _sample_weights(weight, gradient)
    if method == "batched":
        return weighted_kmeans_batched(weight, sw, 2**bits, seed=seed)
    if method == "sklearn":
        return weighted_kmeans_sklearn(weight, sw, 2**bits)
    return weighted_kmeans_native(weight, sw.to(torch.float32), 2**bits,
                                  seed=seed)


def fit_structured_luts(weight: torch.Tensor,
                        gradient: Optional[torch.Tensor], max_iter: int = 25,
                        seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """4-bit STRUCTURED additive codebooks: per channel
    ``lut[c] = A[c & 7] + (c >> 3) * d`` (9 degrees of freedom, not 16).

    Alternating minimization: assignment to the nearest implied centroid,
    then the exact weighted least squares for (A, d) jointly (A_j = (S_j -
    d T_j) / W_j, d from one scalar equation). Init: a free 8-centroid fit
    for A, d the weighted mean |residual|. Stops when every channel moved
    less than 1e-9 (one test for the whole module).

    Returns (lut (out, 16) f32 in STRUCTURED order, not sorted: lut[:, :8]
    = A, lut[:, 8:] = A + d; labels (out, in) uint8 in the same order)."""
    w = weight.to(F64)
    sw = _sample_weights(w, gradient)
    A8, lab8 = weighted_kmeans_batched(w, sw, 8, seed=seed)
    A = A8.to(F64)
    resid = w - A.gather(1, lab8.long())
    d = (resid.abs() * sw).sum(1) / torch.clamp(sw.sum(1), min=1e-30)
    d = torch.clamp(d, min=1e-12)
    sx = _Sorted(w, sw)
    for _ in range(max_iter):
        # per implied centroid c = j + 8 b: sums of w and w*x
        s_w, s_wx, _ = sx.sums(torch.cat([A, A + d[:, None]], 1))
        W_j = s_w[:, :8] + s_w[:, 8:]
        S_j = s_wx[:, :8] + s_wx[:, 8:]
        T_j = s_w[:, 8:]  # b = 1 on the upper half
        swb = T_j.sum(1)
        swbx = s_wx[:, 8:].sum(1)
        Wsafe = torch.clamp(W_j, min=1e-30)
        denom = swb - (T_j * T_j / Wsafe).sum(1)
        numer = swbx - (T_j * S_j / Wsafe).sum(1)
        new_d = torch.where(denom.abs() > 1e-20, numer / denom, d)
        new_A = torch.where(W_j > 0, (S_j - new_d[:, None] * T_j) / Wsafe, A)
        moved = (new_A - A).abs().max(1).values + (new_d - d).abs()
        A, d = new_A, new_d
        if bool((moved < 1e-9).all()):
            break
    lut = torch.cat([A, A + d[:, None]], 1)
    return lut.to(torch.float32), labels(lut, w)


def structured_decomposition(lut, atol: float = 0.0):
    """(A (out, 8) f32, d (out,) f32) numpy if a materialized (out, 16) lut
    has ``lut[:, 8:] - lut[:, :8]`` constant per channel (within atol, or
    1e-6 of max(1, max |lut|)), else None. The JAX package's numpy
    expressions, so A and d equal what it attaches bit for bit."""
    lut = np.asarray(lut.cpu() if isinstance(lut, torch.Tensor) else lut)
    if lut.ndim != 2 or lut.shape[1] != 16:
        return None
    delta = lut[:, 8:] - lut[:, :8]
    dmean = delta.mean(axis=1)
    if np.abs(delta - dmean[:, None]).max() > max(
            atol, 1e-6 * max(1.0, float(np.abs(lut).max()))):
        return None
    return lut[:, :8].astype(np.float32), dmean.astype(np.float32)
