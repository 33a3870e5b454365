"""Zero-copy binary row payloads: the ``application/x-gmm-rows`` frame.

The serving data plane's JSON bottleneck is the request body: a D=16
batch of 4096 rows costs ~65k float literals parsed one at a time into
Python objects, then a list-of-lists walk in ``np.asarray``. This module
defines the versioned little-endian frame both network front ends accept
instead (docs/SERVING.md "Binary payloads"), decoded straight into the
dispatch buffer via ``np.frombuffer`` -- no JSON float parsing, no
intermediate Python lists.

Frame layout (16-byte header, little-endian, then packed rows)::

    offset  size  field
    0       4     magic  b"GMR1" (format version rides in the magic)
    4       1     dtype  0 = float32, 1 = float64
    5       1     reserved (must be 0)
    6       2     reserved (must be 0)
    8       4     u32 D  columns per row
    12      4     u32 N  rows
    16      N*D*itemsize  row-major packed rows

Transport bindings:

- **HTTP** (serving/http.py): a scoring POST with ``Content-Type:
  application/x-gmm-rows`` carries one frame as its entire body; model,
  op, and version ride the URL exactly as for JSON bodies, and the
  deadline rides the ``X-GMM-Deadline-Ms`` header. Responses stay JSON
  either way -- the bit-identity contract is on response bytes.
- **JSONL socket** (serving/server.py): a header line
  ``{"model": ..., "op": ..., "x_bytes": <frame length>}`` -- ``x_bytes``
  REPLACING ``"x"`` -- is followed immediately by exactly that many raw
  frame bytes (a length-prefixed frame; the JSONL framing itself is
  unchanged for JSON requests).

Error taxonomy: a malformed frame (bad magic, truncated or trailing
bytes, absurd shape) answers the machine token ``bad_frame`` -- HTTP 400
via the ``status_for_error`` default -- and an oversized declared frame
answers ``frame_too_large`` before any buffering.

Bit-parity: the JSON path parses ``x`` to float64 before the executor
cast, so a float64 frame of the same values dispatches bit-identically
to its JSON spelling (the parity tests in tests/test_wire.py). A
float32 frame skips the double rounding -- use it only when the client
already holds float32 rows.
"""

from __future__ import annotations

import struct

import numpy as np

#: The HTTP media type a binary scoring body declares.
CONTENT_TYPE = "application/x-gmm-rows"

MAGIC = b"GMR1"
HEADER = struct.Struct("<4sBBHII")  # magic, dtype, pad8, pad16, D, N
HEADER_BYTES = HEADER.size  # 16

_DTYPE_CODES = {0: np.dtype("<f4"), 1: np.dtype("<f8")}
_CODE_FOR = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}


class WireError(ValueError):
    """A frame that violates the x-gmm-rows layout (bad magic, truncated
    or trailing payload, unknown dtype code, zero-D shape)."""


def encode_rows(x: np.ndarray) -> bytes:
    """Pack a ``[n, d]`` float32/float64 row block into one frame.

    Any other dtype (ints, a JSON-parsed object array) is encoded as
    float64 -- exactly the dtype the JSON request path parses into, so
    the two spellings of one request stay bit-identical.
    """
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise WireError(f"rows must be [n, d], got shape {x.shape}")
    if x.dtype not in _CODE_FOR:
        x = x.astype(np.float64)
    x = np.ascontiguousarray(x, dtype=x.dtype.newbyteorder("<"))
    header = HEADER.pack(MAGIC, _CODE_FOR[np.dtype(x.dtype.name)], 0, 0,
                         int(x.shape[1]), int(x.shape[0]))
    return header + x.tobytes()


def frame_bytes(n: int, d: int, dtype) -> int:
    """Total frame size for an ``[n, d]`` block of ``dtype`` rows."""
    return HEADER_BYTES + int(n) * int(d) * np.dtype(dtype).itemsize


def decode_rows(buf: bytes) -> np.ndarray:
    """Unpack one frame into a read-only ``[n, d]`` ndarray view.

    The row block is a ``np.frombuffer`` view over ``buf`` -- zero-copy;
    the serving dispatch concatenates/shifts it into its own buffer, so
    the view's read-only flag never bites. Raises :class:`WireError` on
    any layout violation; the buffer must contain EXACTLY one frame
    (trailing bytes are an error, not ignored -- a client that
    mis-computed ``x_bytes`` must hear about it).
    """
    if len(buf) < HEADER_BYTES:
        raise WireError(
            f"frame truncated: {len(buf)} bytes is shorter than the "
            f"{HEADER_BYTES}-byte header")
    magic, code, pad8, pad16, d, n = HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (expected {MAGIC!r})")
    if pad8 or pad16:
        raise WireError("reserved header bytes must be zero")
    dt = _DTYPE_CODES.get(code)
    if dt is None:
        raise WireError(f"unknown dtype code {code} (0=f32, 1=f64)")
    if d <= 0:
        raise WireError("frame declares D=0 columns")
    want = HEADER_BYTES + n * d * dt.itemsize
    if len(buf) < want:
        raise WireError(
            f"frame truncated: header declares {n}x{d} "
            f"{dt.name} rows ({want} bytes), got {len(buf)}")
    if len(buf) > want:
        raise WireError(
            f"frame has {len(buf) - want} trailing bytes past the "
            f"declared {n}x{d} {dt.name} payload")
    rows = np.frombuffer(buf, dtype=dt, count=n * d,
                         offset=HEADER_BYTES)
    return rows.reshape(n, d)
