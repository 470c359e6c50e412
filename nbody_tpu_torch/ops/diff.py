"""Differentiable N-body stepping.

Counterpart of ``nbody_tpu/ops/diff.py``. The plain PyTorch step is
differentiable once its scalars are tensors (``plain_step_vs``); the CUDA
kernels are not, so ``nbody_step_diff`` pairs them in a
``torch.autograd.Function``: the forward runs the fused step kernel (on a
CUDA tensor), the backward recomputes the mathematically identical plain
step under autograd and returns its vector-Jacobian product. That is the
JAX package's ``custom_vjp`` recompute-for-backward: one more O(N^2) pass
instead of hand-derived Hessian-vector products of the softened potential.

Gradients flow to the positions (all four lanes: the mass too), the
velocities, dt, the softening and the damping, wherever the caller passes a
tensor that requires one (Python floats are allowed and get none). The
backward is built from differentiable operations on the saved inputs, so a
gradient of a gradient works (``examples/fit_softening_torch.py`` takes Newton
steps on one).

Memory: the backward holds the plain step's (C, N) intermediates for every
chunk of rows, about k * N^2 * 4 bytes in float32 with k of 6 to 10, as the
JAX package's chunked VJP does: ~6-11 GB at N = 16384, too much at 65536
for an 80 GB card.

Scalars: the kernels take dt, the softening and the damping as numbers, so
the tensor scalars on the card are stacked there and read on the host
together, once a call of ``nbody_step_diff``, ``rollout_diff`` or a sharded
step, counted in ``utils.timing.HOST_READS["diff_scalars"]``.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops import cuda_kernel as ck
from nbody_tpu_torch.ops import reference
from nbody_tpu_torch.utils import timing

# the keys of a step's `config`, the static kernel options
CONFIG_KEYS = ("variant", "block_size")
STEP_VARIANTS = ("vpu", *reference.MXU_VARIANTS)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """`x` as a 0-d tensor of `like`'s type and device; a tensor stays in
    the autograd graph (``.to`` is differentiable)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=like.dtype, device=like.device)
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def plain_step_vs(pos_i, vel_i, pos_j, dt, softening, damping, *, chunk_size=None):
    """The plain step of the i-set under the j-set with its scalars as
    tensors of the state's type, eps^2 = softening * softening, as
    ``nbody_tpu``'s ``jnp.asarray(softening, pos.dtype) ** 2``: the step
    whose VJP the backward returns. For float scalars it equals
    ``reference.nbody_step_vs`` but where float(softening) ** 2 rounds
    otherwise than the square in the state's type (an ulp of eps^2)."""
    dt, soft, damp = (_scalar(x, pos_i) for x in (dt, softening, damping))
    acc = reference.accel_eps2_vs(pos_i, pos_j, soft * soft, chunk_size=chunk_size)
    return reference.integrate(pos_i, vel_i, acc, dt, damp)


def plain_step(pos, vel, dt, softening, damping, *, chunk_size=None):
    """``plain_step_vs`` of the whole set on itself."""
    return plain_step_vs(pos, vel, pos, dt, softening, damping, chunk_size=chunk_size)


def scalar_values(*scalars) -> tuple:
    """The scalars as Python floats for the kernels: the tensors among them
    stacked on one device (a card's where one lies there) and read on the
    host in one counted read; none when all are floats."""
    tensors = [x for x in scalars if isinstance(x, torch.Tensor)]
    if not tensors:
        return tuple(float(x) for x in scalars)
    device = next((t.device for t in tensors if t.device.type == "cuda"), tensors[0].device)
    read = iter(timing.host_read(torch.stack([t.detach().to(device, torch.float64).reshape(())
                                              for t in tensors]), "diff_scalars"))
    return tuple(next(read) if isinstance(x, torch.Tensor) else float(x) for x in scalars)


def check_config(config) -> dict:
    """The kernel options of a `config` tuple of (key, value) pairs."""
    kw = dict(config)
    unknown = sorted(set(kw) - set(CONFIG_KEYS))
    if unknown:
        raise ValueError(f"unknown config keys {unknown}; expected {CONFIG_KEYS}")
    variant = kw.get("variant", "vpu")
    if variant not in STEP_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {STEP_VARIANTS}")
    return kw


def _forward_step(pos, vel, values, kw):
    """The forward's step: on a CUDA tensor the fused step kernel (row 1,
    or for a variant mxu / mxu_bf16 the tensor-core step, row 3; a float64
    state the double step kernel), on the CPU the plain step."""
    if pos.device.type != "cuda":
        return plain_step(pos, vel, *values)
    variant = kw.get("variant", "vpu")
    if variant in reference.MXU_VARIANTS and pos.dtype == torch.float32:
        return ck.nbody_step_mxu_cuda(pos, vel, *values, variant=variant)
    return ck.nbody_step_cuda(pos, vel, *values,
                              block_size=kw.get("block_size", ck.DEFAULT_BLOCK_SIZE))


def _forward_values(pos, scalars) -> tuple:
    """The scalars the forward passes on: floats for the kernels on a CUDA
    state (the card tensors among them read once), as they are for the
    CPU's plain step."""
    return scalar_values(*scalars) if pos.device.type == "cuda" else tuple(scalars)


def _save(ctx, pos, vel, scalars) -> None:
    """Keep a step's inputs for its backward: the tensors saved, the Python
    floats as they are."""
    ctx.scalars = [None if isinstance(x, torch.Tensor) else x for x in scalars]
    ctx.save_for_backward(pos, vel, *(x for x in scalars if isinstance(x, torch.Tensor)))


def _recompute_vjp(ctx, cotangents, gather=None, chunk_size=None) -> list:
    """The VJP of the saved step, recomputed as the plain step under
    autograd: the gradients of (pos, vel, dt, softening, damping), None for
    an input that wants none, zeros for one the step does not reach. With
    `gather` (a rank's rows -> the whole j-state) the j-state is a leaf of
    its own and its gradient is a sixth entry (None unless pos wants one).
    Each input that wants a gradient enters as an alias in the graph (a
    view), so that its gradient is this step's partial and, with grad mode
    on, the caller's graph sees it for a gradient of a gradient."""
    saved = iter(ctx.saved_tensors)
    pos, vel = next(saved), next(saved)
    inputs = (pos, vel, *(next(saved) if x is None else x for x in ctx.scalars))
    needs = (*ctx.needs_input_grad[:5], gather is not None and ctx.needs_input_grad[0])
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xs = [x if not isinstance(x, torch.Tensor) else x.view_as(x) if need else x.detach()
              for need, x in zip(needs, inputs)]
        pos_j = xs[0] if gather is None else gather(pos.detach()).requires_grad_(needs[5])
        xs.append(pos_j)
        out = plain_step_vs(xs[0], xs[1], pos_j, *xs[2:5], chunk_size=chunk_size)
        wanted = [x for need, x in zip(needs, xs) if need]
        grads = iter(torch.autograd.grad(out, wanted, cotangents, create_graph=create,
                                         allow_unused=True))
    result = []
    for need, x in zip(needs, xs):
        g = next(grads) if need else None
        result.append(torch.zeros_like(x) if need and g is None else g)
    return result


class _StepDiff(torch.autograd.Function):
    """One step: the kernel forward, the plain step's VJP backward."""

    @staticmethod
    def forward(ctx, pos, vel, dt, softening, damping, kw, values):
        _save(ctx, pos, vel, (dt, softening, damping))
        return _forward_step(pos, vel, values, kw)

    @staticmethod
    def backward(ctx, g_pos, g_vel):
        return (*_recompute_vjp(ctx, (g_pos, g_vel))[:5], None, None)


def nbody_step_diff(pos, vel, dt, softening, damping, config=()):
    """One differentiable step; `config` is a static tuple of (key, value)
    kernel options, e.g. (("variant", "vpu"), ("block_size", 256)). Returns
    (new_pos, new_vel)."""
    values = _forward_values(pos, (dt, softening, damping))
    return _StepDiff.apply(pos, vel, dt, softening, damping, check_config(config), values)


def rollout_diff(pos, vel, dt, softening, damping, *, steps: int, config=()):
    """A differentiable `steps`-step rollout. Each step saves only its input
    state (and the scalars), and its backward recomputes that step, as
    ``jax.checkpoint`` around each step does: the backward holds
    O(steps * state) plus one step's intermediates. The scalars are read on
    the host once a call."""
    kw = check_config(config)
    values = _forward_values(pos, (dt, softening, damping))
    for _ in range(int(steps)):
        pos, vel = _StepDiff.apply(pos, vel, dt, softening, damping, kw, values)
    return pos, vel


# ---- the body-sharded step ----

class _ShardedStepDiff(torch.autograd.Function):
    """A rank's step of a 1-D mesh: the sharded step forward; backward the
    plain step of the rank's rows against the gathered j-state (a leaf of
    its own), its j-cotangent summed onto the owners by the fixed-order
    ``ring_reduce_scatter`` and the scalars' gradients summed over the ranks
    in rank order, so every rank holds the same. torch.distributed's
    collectives have no autograd: this is their transpose, written out as
    XLA derives it for ``nbody_tpu`` (all-gather <-> reduce-scatter). The
    collectives of the backward are not themselves differentiated, so the
    sharded step is first order only: a backward that would build a graph
    for a gradient of the gradient (``create_graph=True``) raises, where
    ``nbody_tpu``'s and the single-device ``nbody_step_diff`` give one."""

    @staticmethod
    def forward(ctx, pos, vel, dt, softening, damping, fast, values, chunk_size):
        ctx.fast, ctx.chunk_size = fast, chunk_size
        _save(ctx, pos, vel, (dt, softening, damping))
        return fast(pos, vel, *values)

    @staticmethod
    def backward(ctx, g_pos, g_vel):
        from nbody_tpu_torch.parallel.mesh import all_gather_rows
        from nbody_tpu_torch.parallel.sharded import ring_reduce_scatter

        if torch.is_grad_enabled():
            raise RuntimeError("make_sharded_step_diff is first order only: its backward's "
                               "collectives are not differentiated (create_graph=True)")
        mesh = ctx.fast.mesh
        result = _recompute_vjp(ctx, (g_pos, g_vel), lambda p: all_gather_rows(mesh, p),
                                ctx.chunk_size)
        g_pos_j = result.pop()
        if g_pos_j is not None:
            (own,) = ring_reduce_scatter(mesh, (g_pos_j,), reference.add_fields)
            result[0] = result[0] + own
        scal = [i for i in range(2, 5) if result[i] is not None]
        if scal:
            local = torch.stack([result[i].to(g_pos).reshape(()) for i in scal])[None]
            total = None
            for row in all_gather_rows(mesh, local):  # rank order
                total = row if total is None else total + row
            for k, i in enumerate(scal):
                result[i] = total[k].to(result[i]).reshape(result[i].shape)
        return (*result, None, None, None)


def make_sharded_step_diff(mesh, *, strategy: str = "auto", block_size=None, chunk_size=None):
    """Differentiable body-sharded step over a 1-D mesh of ``parallel/``:
    ``step(pos, vel, dt, softening, damping) -> (pos, vel)``, each this
    rank's shard. The forward is ``make_sharded_step(mesh, backend="auto",
    strategy=...)`` (allgather, ring, ring_fused, sym or auto); the backward
    recomputes the plain step (``_ShardedStepDiff``). Gradients flow to
    pos / vel (this rank's rows) and to the scalars (the same on every
    rank). Every rank must make the same calls, backward included.
    ``step.close()`` frees a fused ring's buffers. A 2-D mesh raises: this
    builder shards over one axis, as ``nbody_tpu``'s does."""
    from nbody_tpu_torch.parallel.sharded import make_sharded_step

    names = tuple(getattr(mesh, "axis_names", ()))
    if len(names) != 1:
        raise ValueError(f"make_sharded_step_diff shards over a 1-D body mesh "
                         f"(parallel.make_mesh); got axes {names}")
    fast = make_sharded_step(mesh, axis=names[0], backend="auto", strategy=strategy,
                             block_size=block_size)

    def step(pos, vel, dt, softening, damping):
        values = scalar_values(dt, softening, damping)
        return _ShardedStepDiff.apply(pos, vel, dt, softening, damping, fast, values,
                                      chunk_size)

    step.close = fast.close
    step.sharded = fast
    return step
