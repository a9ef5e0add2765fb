"""Math helpers (port of `nerf_lidar_tpu/ops/mathx.py`).

`safe_sin` / `safe_cos` wrap large arguments into [0, 100 pi);
`safe_exp` clamps at 88 and keeps the gradient exp(clamped x) beyond it
(the JAX custom JVP). `sorted_interp` keeps the dense masked-extrema form
of the reference: every query is compared with every knot ([..., M, N]
grid), so ties and the clamp at both ends behave exactly as in the JAX
version.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_TINY = 1e-20


@dataclasses.dataclass(frozen=True)
class ShardedGenerator:
    """The randomness of one data shard of a global batch: each draw is
    made at the global batch's shape (`shards` times the rows asked for)
    from `generator`, and this shard's rows [index n, (index + 1) n) of it
    are kept. Ranks whose generators share a state thus draw, row for row,
    what one process draws for the whole batch."""

    generator: torch.Generator
    index: int
    shards: int


def random_rows(draw, shape, generator, **kwargs) -> torch.Tensor:
    """`draw(shape, generator=..., **kwargs)` (`torch.rand`, `torch.randn`)
    of a [n, ...] shape whose first axis runs over the batch's rays; a
    `ShardedGenerator` draws the global batch's rows and keeps its own."""
    if isinstance(generator, ShardedGenerator):
        n = shape[0]
        full = draw((n * generator.shards,) + tuple(shape[1:]),
                    generator=generator.generator, **kwargs)
        return full[generator.index * n:(generator.index + 1) * n]
    return draw(shape, generator=generator, **kwargs)


def safe_div(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """n/d with 0 where d == 0."""
    d_ok = d != 0.0
    safe_d = torch.where(d_ok, d, torch.ones_like(d))
    return torch.where(d_ok, n / safe_d, torch.zeros_like(n))


def safe_sqrt(x: torch.Tensor, eps: float = _TINY) -> torch.Tensor:
    """sqrt clamped away from 0."""
    return torch.sqrt(torch.clamp(x, min=eps))


def safe_trig_helper(x: torch.Tensor, fn, t: float = 100.0 * math.pi):
    return fn(torch.where(torch.abs(x) < t, x, torch.remainder(x, t)))


def safe_cos(x: torch.Tensor) -> torch.Tensor:
    return safe_trig_helper(x, torch.cos)


def safe_sin(x: torch.Tensor) -> torch.Tensor:
    return safe_trig_helper(x, torch.sin)


class _SafeExp(torch.autograd.Function):
    """exp(min(x, 88)) with the gradient exp(min(x, 88)) everywhere (the
    JAX custom JVP `y * x_dot`; autograd through the clamp would give 0
    above 88)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.exp(torch.clamp(x, max=88.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def safe_exp(x: torch.Tensor) -> torch.Tensor:
    """exp(min(x, 88)) whose gradient stays exp(clamped x) for large
    inputs."""
    return _SafeExp.apply(x)


def _find_interval(mask: torch.Tensor, y: torch.Tensor):
    """Given mask[..., M, N] (x >= y boundaries), bracketing values of y."""
    y0 = torch.where(mask, y[..., None], y[..., :1, None]).amax(dim=-2)
    y1 = torch.where(~mask, y[..., None], y[..., -1:, None]).amin(dim=-2)
    return y0, y1


def sorted_interp(x: torch.Tensor, xp: torch.Tensor,
                  fp: torch.Tensor) -> torch.Tensor:
    """interp() where xp and fp are sorted along the last axis.

    x: [..., N], xp/fp: [..., M]. Returns [..., N].
    """
    mask = x[..., None, :] >= xp[..., :, None]
    fp0, fp1 = _find_interval(mask, fp)
    xp0, xp1 = _find_interval(mask, xp)
    offset = torch.clamp(safe_div(x - xp0, xp1 - xp0), 0, 1)
    return fp0 + offset * (fp1 - fp0)


def sorted_interp_quad(x, xp, fpdf, fcdf):
    """Quadratic-CDF interp (integrates a piecewise-linear pdf), used by the
    anti-aliased interlevel loss."""
    mask = x[..., None, :] >= xp[..., :, None]
    fpdf0, fpdf1 = _find_interval(mask, fpdf)
    fcdf0, _ = _find_interval(mask, fcdf)
    xp0, xp1 = _find_interval(mask, xp)
    offset = torch.clamp(safe_div(x - xp0, xp1 - xp0), 0, 1)
    return fcdf0 + (x - xp0) * (fpdf0 + fpdf1 * offset
                                + fpdf0 * (1 - offset)) / 2


def log_lerp(t: float, v0: float, v1: float) -> float:
    """Interpolate log-linearly from v0 (t=0) to v1 (t=1)."""
    if v0 <= 0 or v1 <= 0:
        raise ValueError(f"Interpolants {v0} and {v1} must be positive.")
    lv0, lv1 = math.log(v0), math.log(v1)
    return math.exp(min(max(t, 0.0), 1.0) * (lv1 - lv0) + lv0)


def learning_rate_decay(step: int, lr_init: float, lr_final: float,
                        max_steps: int, lr_delay_steps: int = 0,
                        lr_delay_mult: float = 1.0) -> float:
    """Log-linear decay with an optional reverse-cosine warmup window (on the
    host: the optimizer takes the rate as a Python float each step)."""
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    return delay_rate * log_lerp(step / max_steps, lr_init, lr_final)
