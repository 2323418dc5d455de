"""Distribution / energy-model base API (counterpart of
``mjhmc_tpu.models.base``).

Energies are batched functions of an ``(ndims, nbatch)`` float32 tensor
(or any ``(..., ndims, nbatch)`` stack: they reduce axis −2). ``U`` is the
potential energy: target density ``p(x) ∝ exp(-U(x))``. Random draws take
an explicit ``torch.Generator``; the draw is made on the generator's device
and moved to ``device``, so one seed gives the same chains on every device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Tuple

import torch

Tensor = torch.Tensor


class Distribution:
    """Base energy model.

    Subclasses set ``ndims`` and implement ``potential``; the gradient
    falls back to autograd when a subclass gives no analytic form.
    """

    #: dimensionality of a single chain state
    ndims: int = 0
    #: human-readable registry name
    name: str = "distribution"

    # ---------------------------------------------------------------- energy
    def potential(self, x: Tensor) -> Tensor:
        """U(x). ``x``: (..., ndims, nbatch) → (..., nbatch)."""
        raise NotImplementedError

    def grad_potential(self, x: Tensor) -> Tensor:
        """dU/dx. ``x``: (ndims, nbatch) → (ndims, nbatch)."""
        return self.potential_and_grad(x)[1]

    def potential_and_grad(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        """(U(x), dU/dx) by autograd; subclasses override with analytic forms."""
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            u = self.potential(xr)
            (g,) = torch.autograd.grad(u.sum(), xr)
        return u.detach(), g

    def logdensity(self, x: Tensor) -> Tensor:
        """log p(x) up to a constant = -U(x)."""
        return -self.potential(x)

    def constant(self, name: str, make: Callable[[], object], device) -> Tensor:
        """The model's constant ``name`` (``make()``, a NumPy array) as a
        tensor on ``device``, uploaded once per device and kept: an upload
        from the host waits for the device, so the energies do not make one
        per call."""
        cache = self.__dict__.setdefault("_device_constants", {})
        key = (name, str(torch.device(device)))
        if key not in cache:
            cache[key] = torch.as_tensor(make(), device=device)
        return cache[key]

    # ---- reference-API aliases ---------------------------------------------
    def E(self, x: Tensor) -> Tensor:  # noqa: N802 — reference name
        """Alias of :meth:`potential` (the reference's ``E(X)``)."""
        return self.potential(x)

    def dEdX(self, x: Tensor) -> Tensor:  # noqa: N802 — reference name
        """Alias of :meth:`grad_potential` (the reference's ``dEdX(X)``)."""
        return self.grad_potential(x)

    def init_X(self, generator: torch.Generator, nbatch: int,  # noqa: N802
               device="cpu") -> Tensor:
        """Alias of :meth:`init_x` (the reference's ``init_X()``)."""
        return self.init_x(generator, nbatch, device)

    # ------------------------------------------------------------------ init
    def init_x(self, generator: torch.Generator, nbatch: int,
               device="cpu") -> Tensor:
        """Draw initial chain states, shape (ndims, nbatch). Default: N(0, I)."""
        return randn(generator, (self.ndims, nbatch), device)

    # ------------------------------------------------------------- metadata
    def analytic_mean(self) -> Tensor | None:
        """Exact mean if known (test oracle), shape (ndims,)."""
        return None

    def analytic_var(self) -> Tensor | None:
        """Exact marginal variances if known (test oracle), shape (ndims,)."""
        return None

    # ---------------------------------------------------------------- hash
    def config_dict(self) -> dict:
        """JSON-serializable config, used for the stable hash (same rule as
        the JAX package, so one config hashes alike in both)."""
        if dataclasses.is_dataclass(self):
            d = {}
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if isinstance(v, (int, float, str, bool, type(None))):
                    d[f.name] = v
                elif isinstance(v, (tuple, list)):
                    d[f.name] = list(v)
            d["__class__"] = type(self).__name__
            return d
        return {"__class__": type(self).__name__, "ndims": self.ndims}

    def stable_hash(self) -> str:
        """Deterministic hash keying cached burn-in states."""
        blob = json.dumps(self.config_dict(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def sum_dims(dist, t: Tensor) -> Tensor:
    """Σ over the dims axis (−2) of ``t``: every such sum of the samplers
    goes through here. A distribution whose dims are split over ranks
    (``parallel.model_parallel``) supplies ``sum_dims`` to add the ranks'
    partial sums; the default is ``t.sum(-2)``."""
    hook = getattr(dist, "sum_dims", None)
    return t.sum(dim=-2) if hook is None else hook(t)


def randn(generator: torch.Generator, shape, device) -> Tensor:
    """Standard-normal float32 draw from ``generator``, moved to ``device``."""
    z = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return z.to(device)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[..., Distribution]] = {}


def register(name: str):
    """Class decorator adding a distribution to the registry."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_distribution(name: str, **kwargs) -> Distribution:
    """Instantiate a registered distribution by name."""
    if name not in _REGISTRY:
        raise KeyError(f"no distribution named {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def registry() -> dict:
    return dict(_REGISTRY)
