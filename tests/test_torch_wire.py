"""The port's x-gmm-rows codec (serving/wire.py) against the JAX package's.

A frame written by either package must decode in the other, byte for byte:
the same header, the same packed rows, the same refusal of every malformed
frame (with the same message).
"""

import struct

import numpy as np
import pytest

from cuda_gmm_mpi_tpu.serving import wire as jwire
from cuda_gmm_mpi_tpu_torch.serving import wire as twire


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(37, 5)).astype(np.float32),
        "f64": rng.normal(size=(9, 24)),
        "int64": np.arange(12, dtype=np.int64).reshape(3, 4),
        "one_row": np.arange(4.0),
        "big_endian": rng.normal(size=(3, 2)).astype(">f8"),
        "empty": np.zeros((0, 6), np.float32),
    }


@pytest.mark.parametrize("name", list(_inputs()))
def test_frames_are_byte_identical_and_cross_decode(name):
    x = _inputs()[name]
    ours, theirs = twire.encode_rows(x), jwire.encode_rows(x)
    assert ours == theirs
    for decode, buf in ((jwire.decode_rows, ours), (twire.decode_rows,
                                                    theirs)):
        y = decode(buf)
        want = np.atleast_2d(np.asarray(x))
        assert y.shape == want.shape
        assert y.dtype == np.dtype(want.dtype if want.dtype.kind == "f"
                                   else np.float64).newbyteorder("<")
        np.testing.assert_array_equal(np.asarray(y), want)
        assert not y.flags.writeable


def test_header_constants_and_sizes_match():
    assert (twire.MAGIC, twire.HEADER.format, twire.HEADER_BYTES,
            twire.CONTENT_TYPE) == (jwire.MAGIC, jwire.HEADER.format,
                                    jwire.HEADER_BYTES, jwire.CONTENT_TYPE)
    for n, d, dt in ((9, 3, np.float32), (1, 24, np.float64)):
        assert twire.frame_bytes(n, d, dt) == jwire.frame_bytes(n, d, dt)


def _bad_frames():
    good = bytearray(jwire.encode_rows(np.ones((4, 3))))
    magic = bytearray(good)
    magic[:4] = b"NOPE"
    dtype = bytearray(good)
    dtype[4] = 9
    pad8, pad16 = bytearray(good), bytearray(good)
    pad8[5] = 1
    pad16[6] = 1
    zero_d = jwire.HEADER.pack(jwire.MAGIC, 0, 0, 0, 0, 1) + struct.pack(
        "<d", 1.0)
    return {"magic": bytes(magic), "dtype": bytes(dtype),
            "pad8": bytes(pad8), "pad16": bytes(pad16), "zero_d": zero_d,
            "short_header": bytes(good[:7]), "truncated": bytes(good[:-1]),
            "trailing": bytes(good) + b"\x00"}


@pytest.mark.parametrize("name", list(_bad_frames()))
def test_malformed_frames_are_refused_alike(name):
    buf = _bad_frames()[name]
    msgs = []
    for mod in (twire, jwire):
        with pytest.raises(mod.WireError) as e:
            mod.decode_rows(buf)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
