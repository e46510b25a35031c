"""Plookup h1/h2 multiset split on the device.

Counterpart of ``calculate_h1h2_device`` in
``xlayer_prover_tpu/stark/lookup.py`` (parity with
Polinomial::calculateH1H2_, polinomial.hpp:305-349): the merged multiset
is, for each t-row i in order, t[i] repeated (1 + #f matching t[i], where f
matches the LAST occurrence of its value in t) times; h1 takes the even
positions, h2 the odd.

  1) sort (t ++ f) lexicographically by value, t before f on ties: chained
     stable ``torch.sort`` calls from the last key to the first, on
     sign-flipped keys (int64 holds uint64 patterns);
  2) within each equal-value run, carry the largest t row index forward
     with one ``torch.cummax`` over run-tagged keys;
  3) give each element its merged position (t row i -> 2i, f matched to t
     row m -> 2m + 1) and sort once more.
"""

from __future__ import annotations

import torch

from ..device import SIGN


def calculate_h1h2_device(f_vals, t_vals):
    """f_vals/t_vals: (n, dim) int64 tensors.  Returns (h1, h2, bad);
    ``bad`` (0-d) counts the f rows missing from t (callers check once)."""
    n, dim = t_vals.shape
    if tuple(f_vals.shape) != (n, dim):
        raise ValueError("calculate_h1h2_device: f and t shapes differ")
    device = t_vals.device
    vals = torch.cat([t_vals, f_vals], dim=0)
    is_f = torch.cat([torch.zeros(n, dtype=torch.int64, device=device),
                      torch.ones(n, dtype=torch.int64, device=device)])
    idx = torch.arange(n, dtype=torch.int64, device=device).repeat(2)

    keys = [vals[:, k] ^ SIGN for k in range(dim)] + [is_f]
    perm = torch.arange(2 * n, dtype=torch.int64, device=device)
    for key in reversed(keys):
        order = torch.sort(key[perm], stable=True).indices
        perm = perm[order]
    sv = vals[perm]
    s_isf = is_f[perm]
    s_idx = idx[perm]

    boundary = torch.ones(2 * n, dtype=torch.int64, device=device)
    boundary[1:] = (sv[1:] != sv[:-1]).any(dim=1).to(torch.int64)
    run_id = torch.cumsum(boundary, dim=0)              # 1-based
    big = 2 * n + 2
    t_idx1 = torch.where(s_isf == 0, s_idx + 1, torch.zeros_like(s_idx))
    tagged = run_id * big + t_idx1
    match1 = torch.cummax(tagged, dim=0).values - run_id * big  # last t + 1

    bad = ((s_isf == 1) & (match1 == 0)).sum()
    # merged position; a missing f gets pattern 2^64 - 1 (sorts last)
    pos = torch.where(s_isf == 0, s_idx * 2, (match1 - 1) * 2 + 1)
    order2 = torch.sort(pos ^ SIGN, stable=True).indices
    merged = sv[order2]
    return merged[0::2], merged[1::2], bad
