"""Minimal PCD (Point Cloud Data) file reader (the port's copy of
``depth_correction_tpu/utils/pcd.py``; numpy only).

Replaces the reference's Open3D dependency for reading Ouster scans
(reference: datasets/newer_college.py:29-44). Supports the ascii, binary
and binary_compressed encodings of the common x/y/z(+extra) layouts; the
compressed body goes through the pure-Python LZF decoder
(:func:`lzf_decompress`), which needs no extension module.
"""
from __future__ import annotations

import numpy as np

__all__ = ["read_pcd", "lzf_decompress"]

_PCD_TYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("I", 8): np.int64,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
    ("U", 8): np.uint64,
}


def read_pcd(path: str) -> np.ndarray:
    """Read a .pcd file into a structured numpy array (one field per
    channel; COUNT>1 channels expand to ``name_0..name_{c-1}``)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            raw_line = f.readline()
            if not raw_line:  # EOF before DATA: a blank line is b"\n"
                raise ValueError("truncated PCD header (no DATA line): %s" % path)
            line = raw_line.decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, value = line.partition(" ")
            header[key.upper()] = value.split()
            if key.upper() == "DATA":
                break

        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        encoding = header["DATA"][0].lower()

        dtype_fields = []
        for name, size, typ, count in zip(fields, sizes, types, counts):
            base = _PCD_TYPES[(typ, size)]
            if count == 1:
                dtype_fields.append((name, base))
            else:
                for c in range(count):
                    dtype_fields.append(("%s_%d" % (name, c), base))
        dtype = np.dtype(dtype_fields)

        if encoding == "ascii":
            body = np.loadtxt(f, dtype=np.float64, max_rows=n)
            body = np.atleast_2d(body)
            out = np.zeros(n, dtype=dtype)
            for i, (name, _) in enumerate(dtype_fields):
                out[name] = body[:, i]
            return out
        if encoding == "binary":
            return np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        if encoding == "binary_compressed":
            # [u32 compressed size][u32 uncompressed size][LZF stream] of the
            # FIELD-MAJOR (SoA) body: each field is one contiguous
            # (n, count) block (PCL pcd_io writeBinaryCompressed layout).
            import struct

            comp_size, uncomp_size = struct.unpack("<II", f.read(8))
            raw = lzf_decompress(f.read(comp_size), uncomp_size)
            out = np.zeros(n, dtype=dtype)
            off = 0
            for name, size, typ, count in zip(fields, sizes, types, counts):
                base = _PCD_TYPES[(typ, size)]
                nbytes = n * count * size
                block = np.frombuffer(
                    raw[off : off + nbytes], dtype=base
                ).reshape(n, count)
                off += nbytes
                if count == 1:
                    out[name] = block[:, 0]
                else:
                    for c in range(count):
                        out["%s_%d" % (name, c)] = block[:, c]
            return out
        raise ValueError("Unknown PCD encoding: %s" % encoding)


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """Decompress an LZF stream (the PCD ``binary_compressed`` codec).

    Pure-Python port of the liblzf decoder: a control byte < 32 starts a
    literal run of ``ctrl + 1`` bytes; otherwise its top 3 bits are the
    match length code (7 adds an extension byte) and the remaining 5 bits
    plus the next byte give the back-reference offset.
    """
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run
            run = ctrl + 1
            out += data[i : i + run]
            i += run
            continue
        length = ctrl >> 5
        if i + (1 if length != 7 else 2) > n:
            raise ValueError("corrupt LZF stream: truncated match header")
        if length == 7:
            length += data[i]
            i += 1
        length += 2
        ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
        i += 1
        if ref < 0:
            raise ValueError("corrupt LZF stream: back-reference before start")
        while length > 0:
            # Chunked copy; an overlapping reference (RLE-style) copies the
            # already-appended prefix repeatedly.
            chunk = min(length, len(out) - ref)
            out += out[ref : ref + chunk]
            ref += chunk
            length -= chunk
    if len(out) != expected_size:
        raise ValueError(
            "corrupt LZF stream: got %d bytes, expected %d"
            % (len(out), expected_size)
        )
    return bytes(out)
