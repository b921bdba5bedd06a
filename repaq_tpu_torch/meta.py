"""Illumina read-name splitter.

Splits ``@instr:run:flowcell:lane:tile:x:y name2`` into a prefix
(``name_part1``), four numeric coordinates, and a suffix (``name_part2``).
The exact event sequence of the reference state machine (reference
fastqmeta.cpp:22-80) is reproduced, including its odd behaviors for names
with 4-6 colons followed by a space (later numeric fields overwrite earlier
ones) because those behaviors determine the bytes that end up in the
container.
"""

from dataclasses import dataclass, field

from .util import c_atoi


@dataclass
class FastqMeta:
    name_part1: bytes = b""
    name_part2: bytes = b""
    lane: int = 0  # uint8
    tile: int = 0  # uint16
    x: int = 0  # uint32
    y: int = 0  # uint32
    has_lane_tile_xy: bool = False


def parse_name(name: bytes) -> FastqMeta:
    """Scalar parse, mirroring reference fastqmeta.cpp:22-80 event-for-event."""
    colon = 0
    last_colon_pos = 0
    coords_start_at = 0
    coords_end_at = 0
    lane = 0
    tile = 0
    x = 0
    y = 0

    for i, c in enumerate(name):
        is_colon = c == 0x3A  # ':'
        is_space = c == 0x20  # ' '
        if is_colon:
            colon += 1
        if is_colon or is_space:
            if 4 <= colon <= 7:
                val = c_atoi(name[last_colon_pos + 1 : i])
                if colon == 4:
                    lane = val
                    coords_start_at = last_colon_pos + 1
                elif colon == 5:
                    tile = val
                elif colon == 6:
                    if is_colon:
                        x = val
                elif colon == 7:
                    y = val
                if is_space and colon == 6:
                    y = val
        if is_colon:
            last_colon_pos = i
        if is_space or (is_colon and colon == 7):
            coords_end_at = i
            break

    meta = FastqMeta()
    if coords_start_at > 0 and coords_end_at > 0:
        meta.lane = lane & 0xFF
        meta.tile = tile & 0xFFFF
        meta.x = x & 0xFFFFFFFF
        meta.y = y & 0xFFFFFFFF
        meta.has_lane_tile_xy = True
        meta.name_part1 = name[: coords_start_at - 1]
        meta.name_part2 = name[coords_end_at:]
    else:
        meta.name_part1 = name
    return meta
