"""AdamW with f32 master weights, port of ``repro.training.optimizer``.

The reference's order of operations, kept exactly: the gradients in f32,
their global norm, the clip scale ``min(1, grad_clip / max(norm, 1e-9))``,
the step counter advanced, the learning rate of that step (linear warm-up,
cosine decay), the bias corrections, then per leaf ``m``, ``v``, the
corrected moments and the decoupled weight decay, applied only to leaves of
two or more dimensions in the reference's layout: there each stacked
subtree carries a leading layer axis, so a layer's norm scale (a row of an
(L, d) stack) decays and the final norm's (d,) does not (``ranks``, from
``models.lm.reference_ranks``). The state holds f32 master weights, ``m`` and ``v``;
the model's parameters take the master weights cast to their own type.
``torch.optim.AdamW`` is not used: its order of operations differs.

Everything stays on the parameters' device, the step counter and the
schedule included, so a step reads nothing back to the host.
:func:`opt_state_specs` is the reference's ZeRO-1 rule for a mesh, which
the dry run places the state by. ``fp32_grad_reduce`` (the type of the
reference's cross-pod gradient reduce) is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    step: torch.Tensor     # () int32, on the parameters' device
    master: Tree           # f32 master weights, by parameter name
    m: Tree                # f32 first moment
    v: Tree                # f32 second moment


def init_opt_state(params: Mapping[str, torch.Tensor]) -> OptState:
    """Step 0, the parameters in f32 as master weights, zero moments."""
    dev = next(iter(params.values())).device
    with torch.no_grad():
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            master={k: p.detach().float().clone() for k, p in params.items()},
            m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
            v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
        )


def lr_at(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay; ``step`` an f32 tensor (or a float)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each f32 leaf's sum of squares."""
    gsq = sum(torch.sum(g.float() * g.float()) for g in grads.values())
    return torch.sqrt(gsq)


def step_(cfg: AdamWConfig, params: Tree, grads: Mapping[str, torch.Tensor],
          state: OptState, loss: Optional[torch.Tensor] = None,
          ranks: Optional[Mapping[str, int]] = None):
    """One AdamW step, written into ``params`` (each tensor updated in place
    to its master weight in its own type) and into ``state``'s dicts (each
    entry replaced, leaf by leaf, so that at most one leaf's old and new
    state are alive at once). With ``loss`` (the step's () loss) the NaN
    guard of the reference's train step: where the gradient norm or the
    loss is not finite, every leaf and the step counter keep their old
    values (``torch.where``, no host sync), and ``metrics["skipped"]`` is 1.
    Returns ``(state, metrics)``: the new state (its step counter a new
    tensor) and the f32 ``grad_norm`` and ``lr``, on the device. ``ranks``:
    each leaf's rank in the reference's layout, which decides its decay
    (default: its own)."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        keep = (None if loss is None
                else torch.isfinite(gnorm) & torch.isfinite(loss.detach()))
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state.step + 1
        stepf = step.float()
        lr = lr_at(cfg, stepf)
        b1c = 1.0 - torch.pow(cfg.b1, stepf)
        b2c = 1.0 - torch.pow(cfg.b2, stepf)

        def pick(new, old):
            return new if keep is None else torch.where(keep, new, old)

        for name, p in params.items():
            g = grads[name].float() * scale
            master, m, v = state.master[name], state.m[name], state.v[name]
            m_new = cfg.b1 * m + (1 - cfg.b1) * g
            v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
            mh = m_new / b1c
            vh = v_new / b2c
            rank = master.dim() if ranks is None else ranks[name]
            decay = cfg.weight_decay if rank >= 2 else 0.0
            master_new = master - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                                        + decay * master)
            state.master[name] = pick(master_new, master)
            state.m[name] = pick(m_new, m)
            state.v[name] = pick(v_new, v)
            p.copy_(pick(master_new.to(p.dtype), p))
        state = state._replace(step=pick(step, state.step))
    metrics = {"grad_norm": gnorm, "lr": lr}
    if keep is not None:
        metrics["skipped"] = (~keep).to(torch.int32)
    return state, metrics


def apply_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: OptState,
                 ranks: Optional[Mapping[str, int]] = None):
    """One AdamW step; returns (new params in their own types, new state,
    metrics), leaving the arguments untouched: the reference's function
    (:func:`step_` on copies)."""
    new_params = {k: p.detach().clone() for k, p in params.items()}
    new_state = OptState(state.step, dict(state.master), dict(state.m),
                         dict(state.v))
    new_state, metrics = step_(cfg, new_params, grads, new_state,
                               ranks=ranks)
    return new_params, new_state, metrics


def opt_state_specs(param_specs, params_struct=None, mesh=None,
                    fsdp_axes=("data",)) -> OptState:
    """The reference's ZeRO-1 optimizer-state specs: each parameter's spec
    (``layers.build_param_specs``, by name), with its first unsharded
    dimension that the data axes divide also sharded over them, unless the
    spec already uses a data axis (the experts). ``params_struct``: the
    parameters by name (meta tensors serve); ``mesh``: anything
    ``layers.mesh_sizes`` reads. Without them the states take the
    parameters' specs."""
    from repro_torch.models.layers import P, mesh_sizes

    if params_struct is None or mesh is None:
        states = dict(param_specs)
    else:
        sizes = mesh_sizes(mesh)
        fs = 1
        for a in fsdp_axes:
            fs *= sizes[a]
        fsdp = tuple(fsdp_axes)

        def extend(spec, leaf):
            parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
            used = {a for q in parts if q
                    for a in (q if isinstance(q, tuple) else (q,))}
            if used & set(fsdp):
                return P(*parts)
            for i, (q, dim) in enumerate(zip(parts, leaf.shape)):
                if q is None and fs > 1 and dim % fs == 0 and dim >= fs:
                    parts[i] = fsdp
                    break
            return P(*parts)

        states = {name: extend(spec, params_struct[name])
                  for name, spec in param_specs.items()}
    return OptState(step=P(), master=states, m=states, v=states)
