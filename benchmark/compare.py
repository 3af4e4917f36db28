"""The comparison that decides ``correct``: what the timed replays served
against the plain reference, on a sample of the window's requests drawn
from the seed.

One number, ``logit_gap``, the widest deviation at any checked position,
in units of the reference row's root mean square over the vocabulary:

* at every position, the largest difference between a logit the program
  emitted and the reference's logit for the same token;
* at every position also how far the served token lies from the one the
  reference's sampler chooses (:func:`token_gap`), with room for the
  nucleus' edge to move by rounding.

The first covers the logits that the timed prefill and decode replays
produced (every layer on the path feeds them); the second holds each
served token to the reference where the client received it: greedy
tokens to the reference's best, sampled ones to the reference's nucleus
and its Gumbel-max draw from the same uniform draws.
"""

from __future__ import annotations

import torch

from benchmark import reference

GREEDY = (0.0, 0, 1.0)
#: the share of probability mass by which the nucleus' edge may move: a
#: logit that moves by rounding alone can take a token at the edge into
#: the nucleus or out of it, and with it the draw, where that token's
#: noise is the largest
EDGE = 1e-3


def _scores(ref: torch.Tensor, sampler, u: torch.Tensor):
    """The reference's tempered logits and those plus the Gumbel noise."""
    scaled = reference.tdiv(ref, sampler[0])
    return scaled, scaled + reference.gumbel(u)


def token_gap(ref: torch.Tensor, tok: torch.Tensor, sampler,
              u=None) -> torch.Tensor:
    """How far the served tokens ``tok (positions,)`` lie from the
    reference sampler's choice over ``ref (positions, vocab)``, in logit
    units, f64 ``(positions,)``. Greedy (``sampler[0] <= 0``): the best
    logit less the token's. Sampled, from the uniform draws ``u``: the
    larger of how far the token's tempered logit lies below the least of
    the nucleus widened by :data:`EDGE`, and how far its perturbed logit
    lies below the best of the nucleus narrowed by it, times the
    temperature."""
    tok = tok.to(ref.device)[:, None]
    T, top_k, top_p = sampler
    if T <= 0.0:
        ref = ref.to(torch.float64)
        return torch.amax(ref, dim=-1) - torch.gather(ref, -1, tok)[:, 0]
    scaled, score = _scores(ref, sampler, u)
    outer = reference.cutoff(scaled, top_k, top_p + EDGE)
    inner = reference.cutoff(scaled, top_k,
                             max(top_p - EDGE, EDGE) if top_p < 1 else 1)
    below = torch.clamp_min(outer - torch.gather(scaled, -1, tok), 0.0)
    best = torch.amax(torch.where(scaled < inner, -torch.inf, score),
                      dim=-1, keepdim=True)
    short = torch.clamp_min(best - torch.gather(score, -1, tok), 0.0)
    return torch.maximum(below, short)[:, 0].to(torch.float64) * T


def choose(logits: torch.Tensor, sampler, u=None) -> torch.Tensor:
    """The reference sampler's tokens for ``logits (positions, vocab)``."""
    if sampler[0] <= 0.0:
        return torch.argmax(logits, dim=-1)
    scaled, score = _scores(logits, sampler, u)
    cut = reference.cutoff(scaled, sampler[1], sampler[2])
    return torch.argmax(torch.where(scaled < cut, -torch.inf, score), dim=-1)


def logit_gap(program: torch.Tensor, reference: torch.Tensor,
              served: torch.Tensor, sampler=GREEDY, noise=None) -> float:
    """``program``, ``reference``: ``(requests, positions, vocab)`` logits;
    ``served``: ``(requests, positions)`` token ids; ``sampler``: the
    traffic's ``(temperature, top_k, top_p)``; ``noise``: ``(requests,
    positions, vocab)`` uniform draws, for sampled traffic."""
    worst = 0.0
    for r in range(reference.shape[0]):          # a request at a time
        ref = reference[r].to(torch.float64)
        rms = torch.sqrt(torch.mean(torch.square(ref), dim=-1))
        dev = torch.amax(torch.abs(program[r].to(ref) - ref), dim=-1)
        gap = token_gap(reference[r], served[r], sampler,
                        None if noise is None else noise[r])
        v = float(torch.amax(torch.maximum(dev, gap) / rms))
        if v != v:                               # NaN: nothing to compare
            return v
        worst = max(worst, v)
    return worst


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: each number beside its limit; a number that
    is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
