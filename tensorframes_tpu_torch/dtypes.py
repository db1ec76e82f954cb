"""Scalar dtype registry: the one-to-one frame ⇄ numpy ⇄ torch type mapping.

Capability parity with the reference's dtype registry
(reference: src/main/scala/org/tensorframes/impl/datatypes.scala):

* a closed set of supported scalar types (datatypes.scala:265-267):
  float64, float32, int32, int64, plus *host-only* binary/string columns
  (datatypes.scala:571-622 — strings are single-scalar, never shipped to the
  device; string/binary columns stay resident on the host and are passed
  through verbs untouched).
* strictly one-to-one mapping with **no implicit casting** anywhere
  (datatypes.scala:155-161). A float64 column feeds only a float64
  placeholder; mismatches are errors raised by the validation layer.

Extensions beyond the reference set: bfloat16 / float16, int8/uint8, and
bool. float64 stays float64 on the GPU (no 64-bit demotion pass).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

try:  # bfloat16 numpy arrays need ml_dtypes; without it the type is absent
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BFLOAT16 = None


@dataclasses.dataclass(frozen=True)
class ScalarType:
    """One supported scalar type.

    ``device`` — whether columns of this type may be placed on the device
    and fed to programs. Host-only types (string / binary / object) ride
    along in verbs as pass-through columns.
    """

    name: str
    np_dtype: Optional[np.dtype]  # None for host object columns
    device: bool
    # Zero element used for padding blocks up to bucket sizes.
    zero: object = 0

    def __repr__(self) -> str:
        return f"ScalarType({self.name})"

    @property
    def torch_dtype(self) -> torch.dtype:
        if not self.device:
            raise TypeError(f"{self.name} columns are host-only; no device dtype")
        return _TORCH[self.name]


float64 = ScalarType("float64", np.dtype(np.float64), True, 0.0)
float32 = ScalarType("float32", np.dtype(np.float32), True, 0.0)
int32 = ScalarType("int32", np.dtype(np.int32), True, 0)
int64 = ScalarType("int64", np.dtype(np.int64), True, 0)
bfloat16 = (
    ScalarType("bfloat16", _BFLOAT16, True, 0.0) if _BFLOAT16 is not None else None
)
float16 = ScalarType("float16", np.dtype(np.float16), True, 0.0)
int8 = ScalarType("int8", np.dtype(np.int8), True, 0)
uint8 = ScalarType("uint8", np.dtype(np.uint8), True, 0)
bool_ = ScalarType("bool", np.dtype(np.bool_), True, False)
# Host-only (≙ reference's String/Binary single-scalar columns,
# datatypes.scala:577-581)
string = ScalarType("string", None, False, "")
binary = ScalarType("binary", None, False, b"")

_DEVICE_TYPES = [t for t in (float64, float32, bfloat16, float16, int64, int32, int8, uint8, bool_) if t is not None]
_ALL_TYPES = _DEVICE_TYPES + [string, binary]

_BY_NAME: Dict[str, ScalarType] = {t.name: t for t in _ALL_TYPES}
_BY_NP: Dict[np.dtype, ScalarType] = {t.np_dtype: t for t in _DEVICE_TYPES}

_TORCH: Dict[str, torch.dtype] = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int64": torch.int64,
    "int32": torch.int32,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_BY_TORCH: Dict[torch.dtype, str] = {v: k for k, v in _TORCH.items()}


class UnsupportedTypeError(TypeError):
    """A dtype outside the registry. ≙ the reference's failures in
    ``SupportedOperations.opsFor`` (datatypes.scala:265-324)."""


def default_float() -> ScalarType:
    """The framework's float *policy* dtype for constructed constants
    (DSL ``zeros``/``ones``/``fill``): float64, the reference's Double
    columns (datatypes.scala:265-267)."""
    return float64


def all_types():
    return list(_ALL_TYPES)


def device_types():
    return list(_DEVICE_TYPES)


def by_name(name: str) -> ScalarType:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise UnsupportedTypeError(
            f"Unsupported scalar type {name!r}. Supported: {sorted(_BY_NAME)}"
        ) from None


def from_numpy(dtype) -> ScalarType:
    """Resolve a numpy dtype (or anything np.dtype accepts) to a ScalarType.

    Object / str / bytes dtypes map to the host-only types. No widening, no
    narrowing — an unregistered dtype is an error (datatypes.scala:155-161).
    """
    try:
        dt = np.dtype(dtype)
    except TypeError:
        raise UnsupportedTypeError(f"Not a dtype: {dtype!r}") from None
    if dt in _BY_NP:
        return _BY_NP[dt]
    if dt.kind in ("U", "S"):
        return string if dt.kind == "U" else binary
    if dt.kind == "O":
        return string
    raise UnsupportedTypeError(
        f"Unsupported dtype {dt}. Supported device types: "
        f"{[t.name for t in _DEVICE_TYPES]}; host types: ['string', 'binary']"
    )


def from_torch(dtype: torch.dtype) -> ScalarType:
    """Resolve a torch dtype to its ScalarType (the program-output side of
    the one-to-one mapping)."""
    name = _BY_TORCH.get(dtype)
    if name is None or name not in _BY_NAME:
        raise UnsupportedTypeError(
            f"Unsupported dtype {dtype}. Supported device types: "
            f"{[t.name for t in _DEVICE_TYPES]}"
        )
    return _BY_NAME[name]


def from_python_value(v) -> ScalarType:
    """Infer the ScalarType of one Python scalar cell (analyze path).

    Python ``float`` → float64 and ``int`` → int64, matching the reference's
    inference from Spark SQL DoubleType/LongType rows; numpy scalars map
    through their dtype exactly.
    """
    if isinstance(v, bool):  # before int — bool is an int subclass
        return bool_
    if isinstance(v, (bytes, bytearray)):
        return binary
    if isinstance(v, str):
        return string
    if isinstance(v, int):
        return int64
    if isinstance(v, float):
        return float64
    if isinstance(v, np.generic):
        return from_numpy(v.dtype)
    if isinstance(v, np.ndarray):
        return from_numpy(v.dtype)
    raise UnsupportedTypeError(f"Unsupported cell value of type {type(v).__name__}")


def to_torch(a, device) -> torch.Tensor:
    """Move a host numpy array to ``device`` as a torch tensor of the same
    dtype (bfloat16 crosses as its 16-bit pattern)."""
    a = np.ascontiguousarray(a)
    if _BFLOAT16 is not None and a.dtype == _BFLOAT16:
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Bring a tensor back to the host as a numpy array of the same dtype."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        if _BFLOAT16 is None:  # pragma: no cover
            raise UnsupportedTypeError("bfloat16 host arrays need ml_dtypes")
        return t.view(torch.int16).cpu().numpy().view(_BFLOAT16)
    return t.cpu().numpy()
