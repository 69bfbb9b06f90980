"""K-FAC preconditioner over a layer registry (counterpart of
``kfac_tpu/preconditioner.py``, dense engine).

The state is an explicit :class:`KFACState`, as in the JAX package, and
``step`` returns a new one. The step counter is a host integer, so the
factor and inverse cadence is a Python ``if`` where JAX traces a
``lax.cond``. Gradients are dicts keyed by ``model.named_parameters()``
names; unregistered parameters pass through unchanged.

Knobs of the JAX engine whose slice comes later (health, metrics, the
flight recorder, async inverse refresh, offload, stat compression, compile
watch and host eigendecompositions) raise ``NotImplementedError`` when set.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch

from kfac_tpu_torch import enums
from kfac_tpu_torch.device import resolve_device
from kfac_tpu_torch.hyperparams import ScalarOrSchedule, resolve
from kfac_tpu_torch.layers import capture as capture_lib
from kfac_tpu_torch.layers import registry as registry_lib
from kfac_tpu_torch.ops import factors as factors_lib
from kfac_tpu_torch.ops import klclip


def default_compute_method(
    platform: str | None = None,
) -> tuple[enums.ComputeMethod, str]:
    """Platform-appropriate ``(compute_method, inverse_solver)`` defaults:
    ``'tpu'`` -> (INVERSE, ``'newton_schulz'``); ``'cuda'`` and anything
    else -> (EIGEN, ``'cholesky'``), the JAX package's off-TPU branch."""
    if platform == 'tpu':
        return enums.ComputeMethod.INVERSE, 'newton_schulz'
    return enums.ComputeMethod.EIGEN, 'cholesky'


@dataclasses.dataclass
class KFACState:
    """All K-FAC second-order state.

    ``a``/``g``: EMA Kronecker factors; ``qa``/``qg``/``da``/``dg``:
    eigendecompositions (EIGEN); ``dgda``: fused ``1/(dg (x) da +
    damping)`` with prediv; ``a_inv``/``g_inv``: explicit inverses
    (INVERSE). Unused slots hold empty dicts.
    """

    step: int
    a: dict[str, torch.Tensor]
    g: dict[str, torch.Tensor]
    qa: dict[str, torch.Tensor]
    qg: dict[str, torch.Tensor]
    da: dict[str, torch.Tensor]
    dg: dict[str, torch.Tensor]
    dgda: dict[str, torch.Tensor]
    a_inv: dict[str, torch.Tensor]
    g_inv: dict[str, torch.Tensor]


_LATER_SLICE_KNOBS = (
    'health', 'metrics', 'flight', 'async_inverse', 'offload',
    'stat_compression', 'compile_watch',
)


@dataclasses.dataclass
class KFACPreconditioner:
    """Configuration and step functions for K-FAC preconditioning.

    Args mirror the JAX engine's: ``factor_update_steps`` and
    ``inv_update_steps`` (int or schedule of the step), ``damping``,
    ``factor_decay`` (EMA alpha), ``kl_clip`` (None disables), ``lr`` (for
    the kl-clip scale), ``compute_method`` (None picks
    :func:`default_compute_method` for ``device``), ``inverse_solver``
    (``'cholesky'``, ``'newton_schulz'`` or ``'auto'``, for INVERSE),
    ``newton_schulz_iters`` (the iteration cap), ``prediv_eigenvalues``.
    ``device`` is where the state lives, ``'cuda'`` unless the caller
    passes another.
    """

    registry: registry_lib.Registry
    factor_update_steps: int | Callable[[int], int] = 1
    inv_update_steps: int | Callable[[int], int] = 1
    damping: ScalarOrSchedule = 0.001
    factor_decay: ScalarOrSchedule = 0.95
    kl_clip: ScalarOrSchedule | None = 0.001
    lr: ScalarOrSchedule = 0.1
    compute_method: enums.ComputeMethod | str | None = None
    inverse_solver: str | None = None
    newton_schulz_iters: int = 40
    eigh_impl: str = 'device'
    prediv_eigenvalues: bool = False
    device: str | torch.device = 'cuda'
    health: Any = None
    metrics: Any = None
    flight: Any = None
    async_inverse: Any = None
    offload: Any = None
    stat_compression: Any = None
    compile_watch: Any = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        for knob in _LATER_SLICE_KNOBS:
            if getattr(self, knob) not in (None, False):
                raise NotImplementedError(
                    f'{knob} is not ported to kfac_tpu_torch yet'
                )
        if self.eigh_impl in ('host', 'eig_host'):
            raise NotImplementedError(
                f'eigh_impl={self.eigh_impl!r}: only the device '
                "eigendecomposition ('device', torch.linalg.eigh) is ported"
            )
        if self.eigh_impl != 'device':
            raise ValueError(f'unknown eigh_impl {self.eigh_impl!r}')
        if isinstance(self.compute_method, str):
            try:
                self.compute_method = enums.ComputeMethod[self.compute_method.upper()]
            except KeyError:
                raise ValueError(
                    f'unknown compute_method {self.compute_method!r}; expected '
                    f'one of {[m.name.lower() for m in enums.ComputeMethod]}'
                ) from None
        method, solver = default_compute_method(self.device.type)
        if self.compute_method is None:
            self.compute_method = method
        if self.inverse_solver is None:
            self.inverse_solver = solver
        if self.inverse_solver not in ('cholesky', 'newton_schulz', 'auto'):
            raise ValueError(
                f'unknown inverse_solver {self.inverse_solver!r}; expected '
                "'cholesky', 'newton_schulz', or 'auto'"
            )
        if self.inverse_solver in ('newton_schulz', 'auto') and self.eigen:
            warnings.warn(
                f'inverse_solver={self.inverse_solver!r} has no effect with '
                'the EIGEN compute method (it replaces the INVERSE-method '
                "solve); pass compute_method='inverse' to use it",
                stacklevel=2,
            )
        for name in ('factor_update_steps', 'inv_update_steps'):
            value = getattr(self, name)
            if not callable(value) and value < 1:
                raise ValueError(f'{name} must be >= 1, got {value}')
        if (
            not callable(self.factor_update_steps)
            and not callable(self.inv_update_steps)
            and self.inv_update_steps % self.factor_update_steps != 0
        ):
            warnings.warn(
                'inv_update_steps is not a multiple of factor_update_steps; '
                'some inverse updates will recompute from unchanged factors',
                stacklevel=2,
            )

    @property
    def eigen(self) -> bool:
        return self.compute_method == enums.ComputeMethod.EIGEN

    # ------------------------------------------------------------------ init

    def init(self) -> KFACState:
        """Identity factors and zero decompositions on ``device``."""
        dev = self.device
        state = KFACState(0, {}, {}, {}, {}, {}, {}, {}, {}, {})
        for name, h in self.registry.layers.items():
            na, ng = h.a_factor_shape[0], h.g_factor_shape[0]
            state.a[name] = torch.eye(na, device=dev)
            state.g[name] = torch.eye(ng, device=dev)
            if self.eigen:
                state.qa[name] = torch.zeros((na, na), device=dev)
                state.qg[name] = torch.zeros((ng, ng), device=dev)
                if self.prediv_eigenvalues:
                    state.dgda[name] = torch.zeros((ng, na), device=dev)
                else:
                    state.da[name] = torch.zeros((na,), device=dev)
                    state.dg[name] = torch.zeros((ng,), device=dev)
            else:
                state.a_inv[name] = torch.zeros((na, na), device=dev)
                state.g_inv[name] = torch.zeros((ng, ng), device=dev)
        return state

    # --------------------------------------------------------------- factors

    def update_factors(
        self, state: KFACState, stats: capture_lib.CapturedStats
    ) -> KFACState:
        """EMA-update the running factors from per-batch statistics; layers
        absent from ``stats`` keep theirs."""
        alpha = resolve(self.factor_decay, state.step)
        new_a = {
            n: factors_lib.ema_update(state.a[n], stats.a[n].float(), alpha)
            if n in stats.a else state.a[n]
            for n in state.a
        }
        new_g = {
            n: factors_lib.ema_update(state.g[n], stats.g[n].float(), alpha)
            if n in stats.g else state.g[n]
            for n in state.g
        }
        return dataclasses.replace(state, a=new_a, g=new_g)

    # -------------------------------------------------------------- inverses

    def update_inverses(self, state: KFACState) -> KFACState:
        """Recompute eigendecompositions (or damped inverses) from the
        current factors. Newton-Schulz warm-starts each factor from its
        previous inverse, A then G in registry order, as the JAX engine
        does; the all-zeros inverses of a fresh state take the cold start."""
        damping = resolve(self.damping, state.step)
        if not self.eigen:
            a_inv, g_inv = {}, {}
            for n in self.registry.layers:
                for new, factor, prev in (
                    (a_inv, state.a[n], state.a_inv[n]),
                    (g_inv, state.g[n], state.g_inv[n]),
                ):
                    new[n] = factors_lib.damped_inverse(
                        factor, damping, self.inverse_solver,
                        self.newton_schulz_iters, x0=prev,
                    )
            return dataclasses.replace(state, a_inv=a_inv, g_inv=g_inv)
        qa, qg, da, dg, dgda = {}, {}, {}, {}, {}
        for name in self.registry.layers:
            adec = factors_lib.compute_eigh(state.a[name])
            gdec = factors_lib.compute_eigh(state.g[name])
            qa[name], qg[name] = adec.q, gdec.q
            if self.prediv_eigenvalues:
                dgda[name] = factors_lib.prediv_eigenvalues(adec, gdec, damping)
            else:
                da[name], dg[name] = adec.d, gdec.d
        return dataclasses.replace(state, qa=qa, qg=qg, da=da, dg=dg, dgda=dgda)

    # --------------------------------------------------------- precondition

    def _precondition_one(
        self, state: KFACState, name: str, grad_mat: torch.Tensor, damping
    ) -> torch.Tensor:
        if not self.eigen:
            return factors_lib.inverse_preconditioned_grad(
                grad_mat, state.a_inv[name], state.g_inv[name]
            )
        if self.prediv_eigenvalues:
            v1 = state.qg[name].T @ grad_mat.float() @ state.qa[name]
            v2 = v1 * state.dgda[name]
            return (state.qg[name] @ v2 @ state.qa[name].T).to(grad_mat.dtype)
        return factors_lib.eigen_preconditioned_grad(
            grad_mat,
            factors_lib.EigenDecomp(q=state.qa[name], d=state.da[name]),
            factors_lib.EigenDecomp(q=state.qg[name], d=state.dg[name]),
            damping,
        )

    def precondition(
        self, state: KFACState, grads: dict[str, torch.Tensor]
    ) -> dict[str, torch.Tensor]:
        """Precondition a ``named_parameters``-keyed grads dict.

        kl-clip takes one scalar over all layers, summed in registry order on
        the device (no host sync): every layer's term, their sum and the
        scale in one launch of the kl-clip dot kernel; then every layer is
        scaled in one kernel launch, in place.
        """
        damping = resolve(self.damping, state.step)
        layer_grads = registry_lib.slice_layer_grads(grads, self.registry)
        precond = {}
        gmats = []
        for name, helper in self.registry.layers.items():
            gmat = helper.grads_to_matrix(layer_grads[name])
            pmat = self._precondition_one(state, name, gmat, damping)
            gmats.append(gmat)
            precond[name] = (pmat, helper)
        pmats = [pmat for pmat, _ in precond.values()]
        if self.kl_clip is not None and pmats:
            _, _, scale = klclip.klclip_dot_many(
                pmats, gmats, resolve(self.lr, state.step),
                resolve(self.kl_clip, state.step),
            )
            pmats = factors_lib.kl_clip_apply_many_(pmats, scale)
        out = {
            name: helper.matrix_to_grads(pmat)
            for (name, (_, helper)), pmat in zip(precond.items(), pmats)
        }
        return registry_lib.merge_layer_grads(grads, out, self.registry)

    # ------------------------------------------------------------------ step

    def step(
        self,
        state: KFACState,
        grads: dict[str, torch.Tensor],
        stats: capture_lib.CapturedStats | None,
    ) -> tuple[KFACState, dict[str, torch.Tensor]]:
        """One K-FAC step: maybe update factors and inverses, then
        precondition. ``stats=None`` skips the factor update (a step
        without capture)."""
        step = state.step
        if stats is not None and step % resolve(self.factor_update_steps, step) == 0:
            state = self.update_factors(state, stats)
        if step % resolve(self.inv_update_steps, step) == 0:
            state = self.update_inverses(state)
        new_grads = self.precondition(state, grads)
        return dataclasses.replace(state, step=step + 1), new_grads


def set_grads(model: torch.nn.Module, grads: dict[str, torch.Tensor]) -> None:
    """Write a ``named_parameters``-keyed grads dict into ``param.grad``,
    ready for a ``torch.optim`` step."""
    for n, p in model.named_parameters():
        if n in grads:
            p.grad = grads[n].contiguous()
