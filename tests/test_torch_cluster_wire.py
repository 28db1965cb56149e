"""The cluster wire format of the port (repro_torch.serve.cluster.protocol)
against the JAX package's, in-process: ``build_frame`` gives the same bytes
for the same meta and arrays, each package's ``recv_msg`` decodes the
other's frames to the same arrays (dtypes included; a frame of several
MB too, which the port sends a part at a time), and both refuse a torn,
crc-corrupted or bad-magic frame with ``TornFrameError``."""

import socket
import threading

import numpy as np
import pytest

from repro.serve.cluster import protocol as jax_protocol
from repro_torch.serve.cluster import protocol

PACKAGES = {"torch": protocol, "jax": jax_protocol}
_RECV_TIMEOUT_S = 10.0


def _arrays(case: str) -> dict:
    rng = np.random.default_rng(5)
    grid = rng.standard_normal((6, 8)).astype(np.float32)
    return {
        "f32": {"scores": rng.standard_normal((3, 5)).astype(np.float32)},
        "i64": {"ids": rng.integers(-1, 1 << 40, (3, 5), dtype=np.int64)},
        "i32": {"q_dims": rng.integers(0, 1000, (4, 7), dtype=np.int32)},
        "u8": {"frames": np.frombuffer(rng.bytes(257), np.uint8)},
        "empty": {"scores": np.zeros((3, 0), np.float32),
                  "ids": np.zeros((3, 0), np.int64)},
        "non_contiguous": {"cols": grid[:, ::3], "rows": grid.T},
        "zero_d": {"seq": np.asarray(7, np.int64),
                   "scale": np.float32(0.25)},
        "mixed": {"0:scores": rng.standard_normal((1, 2)).astype(np.float32),
                  "0:ids": np.asarray([[3, -1]], np.int64),
                  "1:q_vals": np.ones((2, 3), np.float32)},
        "none": {},
        # past protocol._JOIN_BELOW: sent a part at a time, the f32 block
        # at an offset not aligned for it
        "large": {"blob": np.frombuffer(rng.bytes(3 << 20), np.uint8),
                  "f32": rng.standard_normal((600, 300)).astype(np.float32)},
    }[case]


CASES = ["f32", "i64", "i32", "u8", "empty", "non_contiguous", "zero_d",
         "mixed", "none", "large"]
META = {"part": "main", "gen": 3, "h": 20, "alpha": 25, "beta": 6,
        "trace": {"tid": "ab", "sid": "cd"}, "subs": [{"x": 1.5}, {}]}


@pytest.mark.parametrize("op", [1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_build_frame_bytes_equal(case, op):
    arrays = _arrays(case)
    got = protocol.build_frame("search", META, arrays, op=op)
    want = jax_protocol.build_frame("search", META, arrays, op=op)
    assert got == want


def _pair():
    a, b = socket.socketpair()
    for s in (a, b):
        s.settimeout(_RECV_TIMEOUT_S)
    return a, b


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("sender,receiver", [("torch", "jax"),
                                             ("jax", "torch")])
def test_recv_decodes_the_other_package(sender, receiver, case):
    arrays = _arrays(case)
    a, b = _pair()
    sent = {}

    def send():        # in a thread: a large frame outgrows the buffers
        sent["n"] = PACKAGES[sender].send_msg(
            a, "reply", {"gen": 2}, arrays, op=PACKAGES[sender].MSG_RESPONSE)
    t = threading.Thread(target=send, daemon=True)
    try:
        t.start()
        op, meta, got = PACKAGES[receiver].recv_msg(b)
        t.join(_RECV_TIMEOUT_S)
        assert not t.is_alive()
        n = sent["n"]
    finally:
        a.close()
        b.close()
    assert n == len(protocol.build_frame("reply", {"gen": 2}, arrays,
                                         op=protocol.MSG_RESPONSE))
    assert op == PACKAGES[receiver].MSG_RESPONSE == 2
    assert meta == {"gen": 2, "cmd": "reply"}
    assert list(got) == list(arrays)
    for k, v in arrays.items():
        # both packages pack through np.ascontiguousarray, which carries a
        # 0-d array as shape (1,)
        v = np.ascontiguousarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)
        if receiver == "torch":     # views of the frame only where aligned
            assert got[k].flags.writeable and got[k].flags.aligned


def _torn(sock, frame: bytes) -> None:
    sock.sendall(frame[: len(frame) // 2])
    sock.close()


def _corrupt(sock, frame: bytes) -> None:
    bad = bytearray(frame)
    bad[-1] ^= 0x40
    sock.sendall(bytes(bad))


def _bad_magic(sock, frame: bytes) -> None:
    sock.sendall(b"XX" + frame[2:])


@pytest.mark.parametrize("fault", [_torn, _corrupt, _bad_magic],
                         ids=["torn", "crc", "magic"])
@pytest.mark.parametrize("sender,receiver", [("torch", "jax"),
                                             ("jax", "torch"),
                                             ("torch", "torch")])
def test_recv_refuses_a_damaged_frame(sender, receiver, fault):
    frame = PACKAGES[sender].build_frame("search", META, _arrays("mixed"))
    a, b = _pair()
    t = threading.Thread(target=fault, args=(a, frame))
    try:
        t.start()
        with pytest.raises(PACKAGES[receiver].TornFrameError):
            PACKAGES[receiver].recv_msg(b)
    finally:
        t.join(_RECV_TIMEOUT_S)
        a.close()
        b.close()


def test_send_msg_corrupt_flag_is_detected():
    """The server's ``corrupt_next`` fault flips a payload bit after the
    crc; the reference's receiver detects the port's corrupted frame."""
    a, b = _pair()
    try:
        protocol.send_msg(a, "reply", {"k": 1}, _arrays("f32"),
                          op=protocol.MSG_RESPONSE, corrupt=True)
        with pytest.raises(jax_protocol.TornFrameError, match="checksum"):
            jax_protocol.recv_msg(b)
    finally:
        a.close()
        b.close()


def test_clean_eof_is_a_connection_error_not_a_torn_frame():
    a, b = _pair()
    a.close()
    try:
        with pytest.raises(ConnectionError) as e:
            protocol.recv_msg(b)
        assert not isinstance(e.value, protocol.TornFrameError)
    finally:
        b.close()
