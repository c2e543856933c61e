"""ctypes bindings for the native runtime library (native/*.cpp).

Native pieces mirror where the reference is native: O-RAN BFP IQ
compression (lib/ofh/compression), the simulated-RF IQ transport
(lib/radio/zmq), and the SPSC baseband ring (lower-PHY pipeline).  The
library auto-builds on first use if a toolchain is present; BFP also has a
NumPy fallback so tests run without it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")


def get_lib():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_native_dir(), "libsrsran_native.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", _native_dir()], check=True, capture_output=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.bfp_compressed_prb_bytes.restype = ctypes.c_int
    lib.bfp_compress.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.bfp_decompress.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.iq_open_rx.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.iq_open_rx.restype = ctypes.c_int
    lib.iq_open_tx.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.iq_open_tx.restype = ctypes.c_int
    lib.iq_send.argtypes = [ctypes.c_int, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_int]
    lib.iq_send.restype = ctypes.c_int
    lib.iq_recv.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.iq_recv.restype = ctypes.c_int
    lib.iq_close.argtypes = [ctypes.c_int]
    lib.ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_int
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ring_pop.restype = ctypes.c_int
    lib.ring_size.argtypes = [ctypes.c_void_p]
    lib.ring_size.restype = ctypes.c_int
    lib.ofh_uplane_size.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ofh_uplane_size.restype = ctypes.c_int
    lib.ofh_uplane_build.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint16,
                                     ctypes.c_uint16, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.ofh_uplane_build.restype = ctypes.c_int
    lib.ofh_uplane_parse.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 10
    lib.ofh_uplane_parse.restype = ctypes.c_int
    lib.ofh_cplane_size.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ofh_cplane_size.restype = ctypes.c_int
    lib.ofh_cplane_build.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_uint16,
                                      ctypes.c_uint16] + [ctypes.c_int] * 7 +
                                     [ctypes.c_void_p, ctypes.c_int])
    lib.ofh_cplane_build.restype = ctypes.c_int
    lib.ofh_cplane_parse.argtypes = ([ctypes.c_void_p, ctypes.c_int] +
                                     [ctypes.c_void_p] * 9 +
                                     [ctypes.c_void_p, ctypes.c_int])
    lib.ofh_cplane_parse.restype = ctypes.c_int
    lib.ofh_uplane_size_static.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ofh_uplane_size_static.restype = ctypes.c_int
    lib.ofh_uplane_build_static.argtypes = list(lib.ofh_uplane_build.argtypes)
    lib.ofh_uplane_build_static.restype = ctypes.c_int
    lib.ofh_uplane_parse_static.argtypes = ([ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int] + [ctypes.c_void_p] * 9)
    lib.ofh_uplane_parse_static.restype = ctypes.c_int
    lib.ofh_cplane_build_comp.argtypes = ([ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_uint16, ctypes.c_uint16] +
                                          [ctypes.c_int] * 6 +
                                          [ctypes.c_void_p, ctypes.c_int])
    lib.ofh_cplane_build_comp.restype = ctypes.c_int
    lib.ofh_cplane_comp_hdr.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ofh_cplane_comp_hdr.restype = ctypes.c_int
    lib.ofh_cplane_size_type0.restype = ctypes.c_int
    lib.ofh_cplane_build_type0.argtypes = ([ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_uint16, ctypes.c_uint16] +
                                           [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.ofh_cplane_build_type0.restype = ctypes.c_int
    lib.ofh_cplane_parse_type0.argtypes = ([ctypes.c_void_p, ctypes.c_int] +
                                           [ctypes.c_void_p] * 10 +
                                           [ctypes.c_void_p])
    lib.ofh_cplane_parse_type0.restype = ctypes.c_int
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# BFP compression
# ---------------------------------------------------------------------------

def bfp_compress(samples: np.ndarray, width: int = 9) -> np.ndarray:
    """int16 IQ (nof_prb*24,) -> compressed bytes."""
    samples = np.ascontiguousarray(samples, np.int16)
    nof_prb = samples.size // 24
    lib = get_lib()
    if lib is not None:
        out = np.empty(nof_prb * lib.bfp_compressed_prb_bytes(width), np.uint8)
        lib.bfp_compress(samples.ctypes.data, nof_prb, width, out.ctypes.data)
        return out
    return _bfp_compress_np(samples, nof_prb, width)


def bfp_decompress(data: np.ndarray, nof_prb: int, width: int = 9) -> np.ndarray:
    data = np.ascontiguousarray(data, np.uint8)
    lib = get_lib()
    if lib is not None:
        out = np.empty(nof_prb * 24, np.int16)
        lib.bfp_decompress(data.ctypes.data, nof_prb, width, out.ctypes.data)
        return out
    return _bfp_decompress_np(data, nof_prb, width)


def _prb_bytes(width: int) -> int:
    return 1 + (24 * width + 7) // 8


def _bfp_compress_np(samples, nof_prb, width):
    out = np.zeros(nof_prb * _prb_bytes(width), np.uint8)
    for p in range(nof_prb):
        blk = samples[p * 24 : (p + 1) * 24].astype(np.int32)
        maxabs = int(np.abs(blk).max())
        e = 0
        while (maxabs >> e) >= (1 << (width - 1)):
            e += 1
        mant = (blk >> e) & ((1 << width) - 1)
        bits = ((mant[:, None] >> np.arange(width - 1, -1, -1)) & 1).reshape(-1)
        dst = p * _prb_bytes(width)
        out[dst] = e
        packed = np.packbits(bits)
        out[dst + 1 : dst + 1 + len(packed)] = packed
    return out


def _bfp_decompress_np(data, nof_prb, width):
    out = np.empty(nof_prb * 24, np.int16)
    pb = _prb_bytes(width)
    for p in range(nof_prb):
        src = data[p * pb : (p + 1) * pb]
        e = int(src[0])
        bits = np.unpackbits(src[1:])[: 24 * width].reshape(24, width)
        mant = (bits * (1 << np.arange(width - 1, -1, -1))).sum(axis=1).astype(np.int32)
        mant = np.where(mant >= (1 << (width - 1)), mant - (1 << width), mant)
        out[p * 24 : (p + 1) * 24] = (mant << e).astype(np.int16)
    return out


# ---------------------------------------------------------------------------
# IQ transport
# ---------------------------------------------------------------------------

class IqSocket:
    """UDP IQ frame endpoint over the native transport."""

    def __init__(self, fd: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.fd = fd

    @classmethod
    def rx(cls, port: int, bind: str = "127.0.0.1") -> "IqSocket":
        fd = get_lib().iq_open_rx(bind.encode(), port)
        if fd < 0:
            raise OSError("iq_open_rx failed")
        return cls(fd)

    @classmethod
    def tx(cls, port: int, dest: str = "127.0.0.1") -> "IqSocket":
        fd = get_lib().iq_open_tx(dest.encode(), port)
        if fd < 0:
            raise OSError("iq_open_tx failed")
        return cls(fd)

    def send(self, slot: int, symbol: int, port_id: int, iq: np.ndarray) -> int:
        """iq: complex64 samples -> int16 interleaved on the wire (Q15)."""
        scaled = np.empty(iq.size * 2, np.int16)
        scaled[0::2] = np.clip(np.round(iq.real * 32767), -32768, 32767)
        scaled[1::2] = np.clip(np.round(iq.imag * 32767), -32768, 32767)
        return self._lib.iq_send(self.fd, slot, symbol, port_id, scaled.ctypes.data, iq.size)

    def recv(self, max_samples: int = 8192, timeout_ms: int = 100):
        buf = np.empty(max_samples * 2, np.int16)
        slot = ctypes.c_uint32()
        symbol = ctypes.c_int()
        port_id = ctypes.c_int()
        n = self._lib.iq_recv(self.fd, ctypes.byref(slot), ctypes.byref(symbol),
                              ctypes.byref(port_id), buf.ctypes.data, max_samples, timeout_ms)
        if n <= 0:
            return None
        iq = (buf[0 : 2 * n : 2].astype(np.float32) + 1j * buf[1 : 2 * n : 2].astype(np.float32)) / 32767.0
        return slot.value, symbol.value, port_id.value, iq.astype(np.complex64)

    def close(self):
        self._lib.iq_close(self.fd)


class SampleRing:
    """SPSC ring of int16 sample blocks."""

    def __init__(self, nof_blocks: int, block_samples: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.block_samples = block_samples
        self._h = lib.ring_create(nof_blocks, block_samples)
        if not self._h:
            raise MemoryError

    def push(self, block: np.ndarray) -> bool:
        block = np.ascontiguousarray(block, np.int16)
        assert block.size == self.block_samples
        return bool(self._lib.ring_push(self._h, block.ctypes.data))

    def pop(self):
        out = np.empty(self.block_samples, np.int16)
        if not self._lib.ring_pop(self._h, out.ctypes.data):
            return None
        return out

    def __len__(self):
        return self._lib.ring_size(self._h)

    def close(self):
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# OFH U-plane serdes (eCPRI + ORAN CUS-style headers + BFP payload)
# ---------------------------------------------------------------------------

def ofh_uplane_build(iq: np.ndarray, *, pc_id=0, seq_id=0, direction=0, frame_id=0,
                     subframe_id=0, slot_id=0, symbol_id=0, start_prb=0,
                     width=9) -> np.ndarray:
    """Serialize int16 interleaved IQ (nof_prb*24,) into one U-plane message."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    iq = np.ascontiguousarray(iq, np.int16)
    nof_prb = iq.size // 24
    out = np.empty(lib.ofh_uplane_size(nof_prb, width), np.uint8)
    n = lib.ofh_uplane_build(out.ctypes.data, len(out), pc_id, seq_id, direction,
                             frame_id, subframe_id, slot_id, symbol_id, start_prb,
                             nof_prb, width, iq.ctypes.data)
    if n < 0:
        raise ValueError("ofh_uplane_build failed")
    return out[:n]


def ofh_uplane_parse(data: np.ndarray):
    """Parse one U-plane message -> (header dict, int16 IQ array)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    data = np.ascontiguousarray(data, np.uint8)
    pc = ctypes.c_uint16(); sq = ctypes.c_uint16()
    di = ctypes.c_int(); fr = ctypes.c_int(); sf = ctypes.c_int(); sl = ctypes.c_int()
    sy = ctypes.c_int(); sp = ctypes.c_int(); wd = ctypes.c_int()
    n = lib.ofh_uplane_parse(data.ctypes.data, len(data), ctypes.byref(pc), ctypes.byref(sq),
                             ctypes.byref(di), ctypes.byref(fr), ctypes.byref(sf),
                             ctypes.byref(sl), ctypes.byref(sy), ctypes.byref(sp),
                             ctypes.byref(wd), None)
    if n < 0:
        raise ValueError("malformed OFH U-plane message")
    iq = np.empty(n * 24, np.int16)
    lib.ofh_uplane_parse(data.ctypes.data, len(data), ctypes.byref(pc), ctypes.byref(sq),
                         ctypes.byref(di), ctypes.byref(fr), ctypes.byref(sf),
                         ctypes.byref(sl), ctypes.byref(sy), ctypes.byref(sp),
                         ctypes.byref(wd), iq.ctypes.data)
    hdr = {"pc_id": pc.value, "seq_id": sq.value, "direction": di.value,
           "frame_id": fr.value, "subframe_id": sf.value, "slot_id": sl.value,
           "symbol_id": sy.value, "start_prb": sp.value, "width": wd.value,
           "nof_prb": n}
    return hdr, iq


# ---------------------------------------------------------------------------
# OFH C-plane (scheduling commands; native/ofh_serdes.cpp)
# ---------------------------------------------------------------------------

import dataclasses as _dc


class _CplaneSectionStruct(ctypes.Structure):
    _fields_ = [("section_id", ctypes.c_uint16), ("start_prbc", ctypes.c_uint16),
                ("num_prbc", ctypes.c_uint8), ("re_mask", ctypes.c_uint16),
                ("num_symbol", ctypes.c_uint8), ("beam_id", ctypes.c_uint16),
                ("freq_offset", ctypes.c_int32)]


@_dc.dataclass(frozen=True)
class CplaneSection:
    section_id: int = 0
    start_prbc: int = 0
    num_prbc: int = 0
    re_mask: int = 0xFFF
    num_symbol: int = 14
    beam_id: int = 0
    freq_offset: int = 0


def ofh_cplane_build(sections, *, rtc_id=0, seq_id=0, direction=1, frame_id=0,
                     subframe_id=0, slot_id=0, start_symbol=0, section_type=1,
                     time_offset=0) -> np.ndarray:
    """Serialize a C-plane message (section type 1 scheduling / 3 PRACH)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(sections)
    arr = (_CplaneSectionStruct * n)()
    for i, s in enumerate(sections):
        for f in ("section_id", "start_prbc", "num_prbc", "re_mask",
                  "num_symbol", "beam_id", "freq_offset"):
            setattr(arr[i], f, getattr(s, f))
    out = np.empty(lib.ofh_cplane_size(section_type, n), np.uint8)
    r = lib.ofh_cplane_build(out.ctypes.data, out.size, rtc_id, seq_id, direction,
                             frame_id, subframe_id, slot_id, start_symbol,
                             section_type, time_offset, ctypes.byref(arr), n)
    if r < 0:
        raise ValueError("ofh_cplane_build failed")
    return out


def ofh_cplane_parse(data: np.ndarray, max_sections: int = 64):
    """Parse a C-plane message -> (header dict, [CplaneSection])."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    data = np.ascontiguousarray(data, np.uint8)
    rtc = ctypes.c_uint16()
    seq = ctypes.c_uint16()
    ints = [ctypes.c_int() for _ in range(7)]
    arr = (_CplaneSectionStruct * max_sections)()
    n = lib.ofh_cplane_parse(data.ctypes.data, data.size, ctypes.byref(rtc),
                             ctypes.byref(seq), *[ctypes.byref(v) for v in ints],
                             ctypes.byref(arr), max_sections)
    if n < 0:
        raise ValueError("malformed C-plane message")
    hdr = {"rtc_id": rtc.value, "seq_id": seq.value, "direction": ints[0].value,
           "frame_id": ints[1].value, "subframe_id": ints[2].value,
           "slot_id": ints[3].value, "start_symbol": ints[4].value,
           "section_type": ints[5].value, "time_offset": ints[6].value}
    secs = [CplaneSection(section_id=arr[i].section_id, start_prbc=arr[i].start_prbc,
                          num_prbc=arr[i].num_prbc, re_mask=arr[i].re_mask,
                          num_symbol=arr[i].num_symbol, beam_id=arr[i].beam_id,
                          freq_offset=arr[i].freq_offset)
            for i in range(min(n, max_sections))]
    return hdr, secs


# ---------------------------------------------------------------------------
# Static-compression OFH variants + C-plane section type 0 (idle/guard)
# ---------------------------------------------------------------------------

def ud_comp_hdr(width: int, direction: int, mode: str = "dynamic",
                method: int = 1) -> int:
    """The udCompHdr byte per the reference's serialize_compression_header:
    static mode and downlink always encode 0; dynamic uplink encodes
    iqWidth<<4|compMeth with width 16 mapping to 0
    (ofh_cplane_message_builder_{static,dynamic}_compression_impl.cpp)."""
    if mode == "static" or direction == 1:
        return 0
    return (((0 if width == 16 else width) & 0xF) << 4) | (method & 0xF)


def ofh_uplane_build_static(iq: np.ndarray, *, pc_id=0, seq_id=0, direction=0,
                            frame_id=0, subframe_id=0, slot_id=0, symbol_id=0,
                            start_prb=0, width=9) -> np.ndarray:
    """Static-compression U-plane message: no udCompHdr on the wire — the
    width is fixed by configuration on both ends."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    iq = np.ascontiguousarray(iq, np.int16)
    nof_prb = iq.size // 24
    out = np.empty(lib.ofh_uplane_size_static(nof_prb, width), np.uint8)
    n = lib.ofh_uplane_build_static(out.ctypes.data, len(out), pc_id, seq_id,
                                    direction, frame_id, subframe_id, slot_id,
                                    symbol_id, start_prb, nof_prb, width,
                                    iq.ctypes.data)
    if n < 0:
        raise ValueError("ofh_uplane_build_static failed")
    return out[:n]


def ofh_uplane_parse_static(data: np.ndarray, width: int):
    """Parse a static-compression U-plane message (configured width)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    data = np.ascontiguousarray(data, np.uint8)
    pc = ctypes.c_uint16(); sq = ctypes.c_uint16()
    ints = [ctypes.c_int() for _ in range(6)]
    n = lib.ofh_uplane_parse_static(data.ctypes.data, len(data), width,
                                    ctypes.byref(pc), ctypes.byref(sq),
                                    *[ctypes.byref(v) for v in ints], None)
    if n < 0:
        raise ValueError("malformed static U-plane message")
    iq = np.empty(n * 24, np.int16)
    lib.ofh_uplane_parse_static(data.ctypes.data, len(data), width,
                                ctypes.byref(pc), ctypes.byref(sq),
                                *[ctypes.byref(v) for v in ints], iq.ctypes.data)
    hdr = {"pc_id": pc.value, "seq_id": sq.value, "direction": ints[0].value,
           "frame_id": ints[1].value, "subframe_id": ints[2].value,
           "slot_id": ints[3].value, "symbol_id": ints[4].value,
           "start_prb": ints[5].value, "width": width, "nof_prb": n}
    return hdr, iq


def ofh_cplane_build_comp(sections, *, rtc_id=0, seq_id=0, direction=1,
                          frame_id=0, subframe_id=0, slot_id=0, start_symbol=0,
                          comp_byte=0) -> np.ndarray:
    """Type-1 C-plane message with an explicit udCompHdr byte (use
    ud_comp_hdr() to derive it from the compression mode)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(sections)
    arr = (_CplaneSectionStruct * n)()
    for i, s in enumerate(sections):
        for f in ("section_id", "start_prbc", "num_prbc", "re_mask",
                  "num_symbol", "beam_id", "freq_offset"):
            setattr(arr[i], f, getattr(s, f))
    out = np.empty(lib.ofh_cplane_size(1, n), np.uint8)
    r = lib.ofh_cplane_build_comp(out.ctypes.data, out.size, rtc_id, seq_id,
                                  direction, frame_id, subframe_id, slot_id,
                                  start_symbol, comp_byte, ctypes.byref(arr), n)
    if r < 0:
        raise ValueError("ofh_cplane_build_comp failed")
    return out


def ofh_cplane_comp_hdr(data: np.ndarray) -> int:
    """Extract the udCompHdr byte of a type-1 C-plane message."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    data = np.ascontiguousarray(data, np.uint8)
    v = lib.ofh_cplane_comp_hdr(data.ctypes.data, data.size)
    if v < 0:
        raise ValueError("not a type-1 C-plane message")
    return v


def ofh_cplane_build_type0(section: "CplaneSection", *, rtc_id=0, seq_id=0,
                           direction=1, frame_id=0, subframe_id=0, slot_id=0,
                           start_symbol=0, time_offset=0, frame_structure=0,
                           cp_length=0) -> np.ndarray:
    """Idle/guard-period indication (C-plane section type 0; reference
    build_idle_guard_period_message, ofh_cplane_message_builder_impl.cpp:222)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    arr = (_CplaneSectionStruct * 1)()
    for f in ("section_id", "start_prbc", "num_prbc", "re_mask",
              "num_symbol", "beam_id", "freq_offset"):
        setattr(arr[0], f, getattr(section, f))
    out = np.empty(lib.ofh_cplane_size_type0(), np.uint8)
    r = lib.ofh_cplane_build_type0(out.ctypes.data, out.size, rtc_id, seq_id,
                                   direction, frame_id, subframe_id, slot_id,
                                   start_symbol, time_offset, frame_structure,
                                   cp_length, ctypes.byref(arr))
    if r < 0:
        raise ValueError("ofh_cplane_build_type0 failed")
    return out


def ofh_cplane_parse_type0(data: np.ndarray):
    """Parse a type-0 idle/guard message -> (header dict, CplaneSection)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    data = np.ascontiguousarray(data, np.uint8)
    rtc = ctypes.c_uint16(); seq = ctypes.c_uint16()
    ints = [ctypes.c_int() for _ in range(8)]
    arr = (_CplaneSectionStruct * 1)()
    r = lib.ofh_cplane_parse_type0(data.ctypes.data, data.size,
                                   ctypes.byref(rtc), ctypes.byref(seq),
                                   *[ctypes.byref(v) for v in ints],
                                   ctypes.byref(arr))
    if r < 0:
        raise ValueError("malformed type-0 C-plane message")
    hdr = {"rtc_id": rtc.value, "seq_id": seq.value, "direction": ints[0].value,
           "frame_id": ints[1].value, "subframe_id": ints[2].value,
           "slot_id": ints[3].value, "start_symbol": ints[4].value,
           "time_offset": ints[5].value, "frame_structure": ints[6].value,
           "cp_length": ints[7].value}
    sec = CplaneSection(section_id=arr[0].section_id, start_prbc=arr[0].start_prbc,
                        num_prbc=arr[0].num_prbc, re_mask=arr[0].re_mask,
                        num_symbol=arr[0].num_symbol, beam_id=arr[0].beam_id,
                        freq_offset=arr[0].freq_offset)
    return hdr, sec
