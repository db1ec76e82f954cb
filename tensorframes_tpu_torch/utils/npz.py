"""Raw-bytes array codec for npz storage, without ``ml_dtypes``.

numpy's npz loader cannot reconstruct bfloat16 (without ``ml_dtypes`` it
has no such type at all), so the checkpoint backend (checkpoint.py)
stores every array as its flat uint8 bytes, with the dtype and shape
recorded out of band in a JSON manifest: ``{"dtype": "bfloat16",
"shape": [3, 2]}``. The entries are the reference package's, so either
package reads what the other wrote. A dtype numpy knows decodes through
numpy; any other (``bfloat16``) through torch, as a byte view.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _torch_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def encode_array(x) -> Tuple[np.ndarray, Dict]:
    """A tensor, numpy array or Python scalar → (flat uint8 view, {"dtype",
    "shape"} manifest entry). A tensor is copied to the host (a CUDA
    tensor waits for its device); a contiguous host array is viewed, not
    copied. The shape is taken before the flattening, so a 0-d leaf keeps
    shape ``[]``."""
    if torch.is_tensor(x):
        t = x.detach().to("cpu").contiguous()
        shape = list(t.shape)
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return raw, {"dtype": _torch_name(t.dtype), "shape": shape}
    arr = np.asarray(x)
    shape = list(arr.shape)
    arr = np.ascontiguousarray(arr)
    return arr.reshape(-1).view(np.uint8), {"dtype": str(arr.dtype), "shape": shape}


def decode_array(raw: np.ndarray, entry: Dict) -> torch.Tensor:
    """Inverse of :func:`encode_array`: a CPU tensor of the entry's dtype
    and shape over ``raw``'s bytes (no copy; ``np.load`` hands back fresh
    writable arrays). ``bfloat16`` and the other dtypes numpy lacks are
    read as ``torch.from_numpy(raw).view(torch.<dtype>)``."""
    name, shape = entry["dtype"], entry["shape"]
    raw = np.ascontiguousarray(raw).reshape(-1)
    try:
        np_dtype = np.dtype(name)
    except TypeError:
        np_dtype = None
    if np_dtype is not None and np_dtype.kind != "V":
        return torch.from_numpy(raw.view(np_dtype)).reshape(shape)
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"unknown array dtype {name!r} in the manifest")
    return torch.from_numpy(raw.view(np.uint8)).view(dtype).reshape(shape)
