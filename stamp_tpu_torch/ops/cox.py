"""Cox proportional-hazards partial-likelihood losses in PyTorch.

Counterpart of ``stamp_tpu/ops/cox.py:22-167`` (the reference's
torchsurv-derived implementation plus the slide-level Breslow variant),
operation for operation: the risk-set log-denominators by a reversed
``logcumsumexp``, the Efron tie correction segment-wise by scatter
reductions over tie groups, NaN-labelled samples pushed to the end of the
sort and out of every risk set.  Without ties the Efron formula reduces
exactly to the plain Cox partial likelihood, so one code path covers both.
``torch.minimum``/``maximum`` are used where the JAX code clamps, because
they split the gradient at a tie the way ``jnp.minimum``/``maximum`` do.
"""

from __future__ import annotations

import torch


def _cumlogsumexp_rev(x: torch.Tensor) -> torch.Tensor:
    """log(sum_{j>=i} exp(x_j)) for each i."""
    return torch.flip(torch.logcumsumexp(torch.flip(x, (0,)), dim=0), (0,))


def neg_partial_log_likelihood(
    log_hz: torch.Tensor,
    time: torch.Tensor,
    event: torch.Tensor,
    *,
    ties_method: str = "efron",
    reduction: str = "mean",
) -> torch.Tensor:
    """Negative Cox partial log-likelihood with Efron (default) or Breslow ties.

    Args:
        log_hz: [N] log relative hazards.
        time:   [N] event or censoring times.
        event:  [N] 1 = event, 0 = censored.

    NaN-labelled samples (missing time or status) are excluded.
    """
    log_hz = log_hz.reshape(-1)
    time = time.reshape(-1)
    event = event.reshape(-1)
    n = log_hz.shape[0]
    dev, dtype = log_hz.device, log_hz.dtype
    neg_inf = torch.tensor(-torch.inf, dtype=dtype, device=dev)

    valid = ~(torch.isnan(time) | torch.isnan(event))
    event_b = torch.where(valid, event > 0, False)
    # push invalid samples to the end of the sort and out of every risk set
    time_f = torch.where(valid, time, torch.tensor(3.4e38, dtype=time.dtype, device=dev))

    order = torch.argsort(time_f, stable=True)
    t_s = time_f[order]
    lh_s = torch.where(valid, log_hz, neg_inf)[order]
    ev_s = event_b[order]

    # Breslow/no-ties risk-set denominator: log sum_{j: t_j >= t_i} exp(lh_j),
    # evaluated at the first index of each tied-time group
    log_denom = _cumlogsumexp_rev(lh_s)

    is_new_group = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), t_s[1:] != t_s[:-1]])
    group_id = torch.cumsum(is_new_group.long(), dim=0) - 1
    arange = torch.arange(n, device=dev)
    first_idx = torch.full((n,), n - 1, dtype=torch.long, device=dev).scatter_reduce(
        0, group_id, arange, reduce="amin"
    )
    log_denom_group = log_denom[first_idx][group_id]

    if ties_method == "breslow":
        pll = lh_s - log_denom_group
    elif ties_method == "efron":
        ev_f = ev_s.to(dtype)
        m_g = torch.zeros(n, dtype=dtype, device=dev).index_add(0, group_id, ev_f)[group_id]
        # log-sum-exp of the tied event hazards per group (stable via group max)
        ev_lh = torch.where(ev_s, lh_s, neg_inf)
        grp_max = torch.full((n,), -torch.inf, dtype=dtype, device=dev).scatter_reduce(
            0, group_id, ev_lh, reduce="amax"
        )
        grp_max_safe = torch.where(torch.isfinite(grp_max), grp_max, 0.0)
        exp_shift = torch.where(ev_s, torch.exp(lh_s - grp_max_safe[group_id]), 0.0)
        grp_sum = torch.zeros(n, dtype=dtype, device=dev).index_add(0, group_id, exp_shift)
        log_tied = torch.where(
            grp_sum > 0,
            torch.log(torch.maximum(grp_sum, torch.tensor(1e-38, dtype=dtype, device=dev))) + grp_max_safe,
            neg_inf,
        )
        log_tied_g = log_tied[group_id]

        # rank of each event within its tie group (0-based, events only)
        ev_cum = torch.cumsum(ev_f, dim=0)
        ev_before_group = torch.cat([torch.zeros(1, dtype=dtype, device=dev), ev_cum])[first_idx][group_id]
        r = ev_cum - 1.0 - ev_before_group

        # log(denom − r/m · tied) = a + log1p(−(r/m)·exp(b − a))
        frac = torch.where(m_g > 0, r / torch.clamp_min(m_g, 1.0), 0.0)
        # guard −inf − −inf → nan (groups of invalid rows): masked out below,
        # but a nan here would poison gradients
        both_finite = torch.isfinite(log_tied_g) & torch.isfinite(log_denom_group)
        log_ratio = torch.where(
            both_finite,
            torch.where(both_finite, log_tied_g, 0.0) - torch.where(both_finite, log_denom_group, 0.0),
            neg_inf,
        )
        zero = torch.zeros((), dtype=dtype, device=dev)
        correction = frac * torch.exp(torch.minimum(log_ratio, zero))
        log_denom_efron = log_denom_group + torch.log1p(
            -torch.minimum(correction, torch.tensor(1.0 - 1e-7, dtype=dtype, device=dev))
        )
        pll = lh_s - log_denom_efron
    else:
        raise ValueError(f'Ties method {ties_method} should be one of ["efron", "breslow"]')

    pll = torch.where(ev_s, pll, torch.nan)
    n_events = ev_s.sum()

    if reduction.lower() == "mean":
        loss = -torch.nansum(pll) / torch.clamp_min(n_events, 1)
    elif reduction.lower() == "sum":
        loss = -torch.nansum(pll)
    else:
        raise ValueError(f"Reduction {reduction} is not implemented yet, should be one of ['mean', 'sum'].")
    # no events → zero loss (reference cox.py:221-226)
    return torch.where(n_events > 0, loss, 0.0)


def cox_loss_breslow(scores: torch.Tensor, times: torch.Tensor, events: torch.Tensor) -> torch.Tensor:
    """Breslow negative partial log-likelihood, max-shift stabilized (the
    slide-level ``LitSurvivalBase.cox_loss``): risk set j ∈ R_i iff
    t_j >= t_i, mean over events; zero when no events."""
    scores = scores.reshape(-1)
    events_b = events.reshape(-1) > 0
    times = times.reshape(-1)

    valid = ~(torch.isnan(times) | torch.isnan(events.reshape(-1)))
    events_b = events_b & valid

    max_scores = torch.where(valid, scores, -torch.inf).max()
    max_scores = torch.where(torch.isfinite(max_scores), max_scores, 0.0)
    exp_s = torch.where(valid, torch.exp(scores - max_scores), 0.0)

    # risk_mask[i, j] = t_i <= t_j (row i = event i's risk set)
    risk_mask = (times[:, None] <= times[None, :]) & valid[None, :]
    lse = torch.log(torch.clamp_min(risk_mask.to(exp_s.dtype) @ exp_s, 1e-38)) + max_scores

    loglik = torch.where(events_b, scores - lse, torch.nan)
    n_events = events_b.sum()
    loss = -torch.nansum(loglik) / torch.clamp_min(n_events, 1)
    return torch.where(n_events > 0, loss, 0.0)
