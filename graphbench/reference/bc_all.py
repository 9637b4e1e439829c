"""Betweenness of every vertex: Brandes from every present source, in float64,
as level-synchronous products with the dense adjacency (plain
``torch.matmul``), a block of sources at a time.

``score[v] = sum over present sources s of delta(s | v)``; an absent
vertex scores NaN.
"""
from __future__ import annotations

import math

import torch


def bc_scores(e, device="cpu", block: int = 4096) -> torch.Tensor:
    """float64 ``[n]`` scores of the live edges ``e`` (``graph.Edges``)."""
    n = e.n
    dev = torch.device(device)
    a = torch.zeros((n, n), dtype=torch.float64, device=dev)
    a[torch.as_tensor(e.src, device=dev), torch.as_tensor(e.dst, device=dev)] = 1.0
    alive = torch.as_tensor(e.alive, device=dev)
    scores = torch.zeros(n, dtype=torch.float64, device=dev)
    for s0 in range(0, n, block):
        srcs = torch.arange(s0, min(n, s0 + block), device=dev)
        b = srcs.numel()
        rows = torch.arange(b, device=dev)
        ok = alive[srcs]
        sigma = torch.zeros((b, n), dtype=torch.float64, device=dev)
        sigma[rows, srcs] = ok.double()
        level = torch.full((b, n), -1, dtype=torch.int32, device=dev)
        level[rows[ok], srcs[ok]] = 0
        front, lvl = sigma, 0
        while bool(front.any()):
            adds = front @ a
            newly = (adds > 0) & (level < 0)
            sigma = torch.where(newly, adds, sigma)
            level[newly] = lvl + 1
            front = torch.where(newly, sigma, 0.0)
            lvl += 1
            del adds, newly
        safe = torch.where(sigma > 0, sigma, 1.0)
        delta = torch.zeros_like(sigma)
        for l in range(lvl - 1, -1, -1):
            g = torch.where(level == l + 1, (1.0 + delta) / safe, 0.0)
            delta += torch.where(level == l, sigma * (g @ a.t()), 0.0)
            del g
        delta[level == 0] = 0.0
        scores += delta.sum(dim=0)
        del sigma, level, front, safe, delta
    return torch.where(alive, scores, math.nan)
