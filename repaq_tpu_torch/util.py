"""Small host-side helpers shared across the package."""

import numpy as np

_WHITESPACE = b" \t\n\v\f\r"

_INT64_MAX = (1 << 63) - 1
_INT64_MIN = -(1 << 63)


def c_atoi(field: bytes) -> int:
    """C `atoi` semantics: skip leading whitespace, optional sign, digits.

    Matches how the reference parses lane/tile/x/y name fields (reference
    fastqmeta.cpp:40 uses atoi). Saturates at int64 like glibc strtol, then
    truncates to int32 like the (int) cast in atoi.
    """
    i = 0
    n = len(field)
    while i < n and field[i : i + 1] in (b" ", b"\t", b"\n", b"\v", b"\f", b"\r"):
        i += 1
    sign = 1
    if i < n and field[i : i + 1] in (b"+", b"-"):
        if field[i] == ord("-"):
            sign = -1
        i += 1
    val = 0
    saturated = False
    while i < n and 0x30 <= field[i] <= 0x39:
        if not saturated:
            val = val * 10 + (field[i] - 0x30)
            if val * sign > _INT64_MAX:
                val = _INT64_MAX if sign > 0 else -_INT64_MIN
                saturated = True
        i += 1
    val *= sign
    if saturated:
        val = _INT64_MAX if sign > 0 else _INT64_MIN
    # (int) cast: keep low 32 bits, interpret as signed.
    val &= 0xFFFFFFFF
    if val >= 1 << 31:
        val -= 1 << 32
    return val


def u32le(value: int) -> bytes:
    return int(value & 0xFFFFFFFF).to_bytes(4, "little")


def u16le(value: int) -> bytes:
    return int(value & 0xFFFF).to_bytes(2, "little")


def read_exact(stream, n: int) -> bytes:
    """Read exactly n bytes or as many as remain (short read near EOF)."""
    data = stream.read(n)
    if data is None:
        return b""
    while len(data) < n:
        more = stream.read(n - len(data))
        if not more:
            break
        data += more
    return data


def ascii_digits_u32(values: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Vectorized unsigned-int -> decimal ASCII.

    Returns (digits, lengths): digits is a (n, 10) uint8 array right-aligned
    at column `10 - length`, lengths the decimal length of each value.
    """
    values = values.astype(np.uint32)
    n = values.shape[0]
    digits = np.empty((n, 10), dtype=np.uint8)
    v = values.astype(np.int64)
    for col in range(9, -1, -1):
        digits[:, col] = (v % 10 + 0x30).astype(np.uint8)
        v //= 10
    # decimal length: number of significant digits, minimum 1
    lengths = np.full(n, 1, dtype=np.int64)
    v = values.astype(np.int64) // 10
    while np.any(v > 0):
        lengths += (v > 0).astype(np.int64)
        v //= 10
    return digits, lengths
