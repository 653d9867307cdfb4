"""Error taxonomy of the PyTorch port.

The class names match the JAX package's taxonomy, so a caller catches the
same type whichever package raised it. Container errors subclass
:class:`ValueError`, the type older callers already handle.

:class:`NotPortedError` marks a feature that the JAX package has and this
port does not run yet (container v3, the chunked frames). It is raised at
the point of use.
"""
from __future__ import annotations


class ContainerError(ValueError):
    """Base for all container integrity failures (subclasses ValueError
    for compatibility with pre-taxonomy callers)."""


class SpecError(ValueError):
    """A compression-spec string failed to parse or validate: bad grammar,
    unknown keys, or values that :class:`~repro_torch.core.CompressorSpec`
    rejects. Subclasses ``ValueError``."""


class BoundViolationError(RuntimeError):
    """Post-compression bound verification found ``max|x - x_hat|`` above
    the declared error bound and the repair ladder could not fix it.
    Carries ``max_err`` / ``bound`` / ``repairs`` for attribution."""

    def __init__(self, msg: str, *, max_err: float = 0.0, bound: float = 0.0,
                 repairs: int = 0):
        super().__init__(msg)
        self.max_err = float(max_err)
        self.bound = float(bound)
        self.repairs = int(repairs)


class NotPortedError(NotImplementedError):
    """The JAX package supports this feature; the PyTorch port does not yet."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not yet ported to repro_torch "
                         "(the JAX package repro supports it)")
