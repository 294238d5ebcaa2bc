"""`leaf_cnn.msgpack` I/O in flax's serialization format, without flax.

`flax.serialization.to_bytes` writes the variable tree as a msgpack map of
maps whose array leaves are msgpack ext type 1, each holding
`packb((shape, dtype name, C-order bytes))`. This module reads and writes
exactly that (`msgpack` is imported when a file is read or written), so
either package can load a model the other saved.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np

_EXT_NDARRAY = 1  # flax.serialization._MsgpackExtType.ndarray


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code != _EXT_NDARRAY:
        raise ValueError(f"unexpected msgpack ext type {code} in checkpoint")
    shape, name, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)


def load_model_msgpack(path: Path | str) -> Dict[str, Any]:
    """Raw nested dict of numpy arrays, as `flax.serialization.msgpack_restore`
    returns it."""
    import msgpack

    return msgpack.unpackb(Path(path).read_bytes(), ext_hook=_ext_hook,
                           raw=False)


def _ext_default(x):
    import msgpack

    if isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        payload = msgpack.packb((list(a.shape), a.dtype.name, a.tobytes("C")),
                                use_bin_type=True)
        return msgpack.ExtType(_EXT_NDARRAY, payload)
    raise TypeError(f"cannot serialise {type(x).__name__}")


def save_model_msgpack(path: Path | str, variables: Dict[str, Any]) -> None:
    """Write {params, batch_stats, norm_stats} of numpy arrays."""
    import msgpack

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack.packb(variables, default=_ext_default,
                                   strict_types=True))
