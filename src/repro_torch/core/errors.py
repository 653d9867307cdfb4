"""Error taxonomy and damage reporting of the PyTorch port.

The class names, the hierarchy and :meth:`DamageReport.summary` match the
JAX package's taxonomy, so a caller catches the same type whichever
package raised it. Container errors subclass :class:`ValueError`, the type
older callers already handle.

The salvage paths (:func:`repro_torch.core.frames.scan_frames`,
``Compressor.decompress(on_error="skip"|"fill")``) do not raise for
damage they can recover from; they return a :class:`DamageReport` that
says what was lost, where, and what was done about it.
"""
from __future__ import annotations

import dataclasses


class ContainerError(ValueError):
    """Base for all container integrity failures (subclasses ValueError
    for compatibility with pre-taxonomy callers)."""


class TruncatedContainerError(ContainerError):
    """The stream ended early: inside a frame, inside a prefix, or with a
    missing/inconsistent end marker."""


class FrameCRCError(ContainerError):
    """A frame payload failed its CRC32 check."""

    def __init__(self, msg: str, *, index: int | None = None, offset: int | None = None):
        super().__init__(msg)
        self.index = index
        self.offset = offset


class FrameSyncError(ContainerError):
    """A sync-marked stream had a bad/missing per-frame sync marker."""


class CheckpointDamageError(RuntimeError):
    """A checkpoint leaf failed its integrity check under ``strict=True``."""


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


@dataclasses.dataclass
class DamageRecord:
    """One damaged region: what kind, where, and which frame (when known)."""

    kind: str                 # "crc" | "length" | "sync" | "truncated" | "trailer" | "decode"
    offset: int               # byte offset where the damage was detected
    index: int | None = None  # frame index/sequence number, when known
    detail: str = ""

    def __str__(self):
        at = f" frame {self.index}" if self.index is not None else ""
        return f"[{self.kind}]{at} @ byte {self.offset}" + (f": {self.detail}" if self.detail else "")


@dataclasses.dataclass
class DamageReport:
    """What a salvage pass found: intact counts, damage records, skipped
    bytes. ``ok`` is True iff the stream was fully intact."""

    records: list = dataclasses.field(default_factory=list)
    frames_ok: int = 0
    frames_damaged: int = 0
    bytes_skipped: int = 0
    declared_frames: int | None = None  # trailer count, when the trailer survived
    truncated: bool = False

    @property
    def ok(self) -> bool:
        return not self.records and not self.truncated

    def add(self, kind: str, offset: int, *, index: int | None = None, detail: str = "") -> DamageRecord:
        rec = DamageRecord(kind, int(offset), index, detail)
        self.records.append(rec)
        return rec

    def summary(self) -> str:
        if self.ok:
            return f"intact: {self.frames_ok} frames"
        parts = [f"{self.frames_ok} frames ok, {self.frames_damaged} damaged"]
        if self.bytes_skipped:
            parts.append(f"{self.bytes_skipped} bytes skipped")
        if self.truncated:
            parts.append("stream truncated")
        return "; ".join(parts) + " | " + "; ".join(str(r) for r in self.records)
