"""The width classes of the forwards #1, #3 and #5 (and of the loop backward
#4 up to 256 columns): one table, one row a class, that every plan, gate
and choice of a build reads.

A class is named by the widest D, G and O it takes (``kMaxWidth`` of
``csrc/scann_common.cuh``: 4, 8 or 16 values of a row a lane in the warp
LayerNorms). Up to 128 columns the builds that always were; past 128 the
``*_d256`` builds, past 256 the ``*_d512`` ones. Each row carries the
constants of its builds that the Python plans mirror:

- ``chunk_rows``: #5's chunk of rows in the narrow build past 128 columns
  and its wide build's sub-chunk (``kD256ChunkRows`` of
  ``csrc/local_attention.cu``; 64 up to 128 columns, ``MAX_CHUNK_ROWS``);
- ``narrow_max_n``: the largest N of #5's narrow build (``kNarrowMaxN``):
  an atom's list within one chunk of 64 rows up to 256 columns; past 256
  one chunk of 16, since two operand buffers of 32 rows take 263,168 bytes
  at D = 512;
- ``tall_max_n``: the largest N of #3's narrow and tall builds
  (``kTallMaxN`` of ``csrc/scann_loop.cu``): two tall chunk buffers of
  more rows do not fit a block's shared memory at the class's width, so the
  wide build takes the rest;
- ``wide_forward_rows``: the wide #3's sub-chunk (``kFwdWideW32Rows`` of
  ``csrc/scann_forward_common.cuh``, ``kWideRows`` of ``scann_loop.cu``):
  one buffer of 64 rows up to 128 columns, past it two buffers, the next
  staged while one runs, in what one buffer of 64 rows took at D = 256;
- ``atom_blocks``: the atom blocks of #5's narrow build (``kAtomBlocks``),
  down to 8 atoms past 128 columns (16 atoms at D = 256, N = 32) and to 4
  past 256.
"""

from typing import NamedTuple, Tuple


class WidthClass(NamedTuple):
    width: int
    suffix: str
    chunk_rows: int
    narrow_max_n: int
    tall_max_n: int
    wide_forward_rows: int
    atom_blocks: Tuple[int, ...]


CLASSES = (
    WidthClass(128, "", 64, 64, 64, 64, (64, 48, 32, 16)),
    WidthClass(256, "_d256", 32, 64, 32, 32, (64, 48, 32, 16, 8)),
    WidthClass(512, "_d512", 16, 16, 16, 16, (64, 48, 32, 16, 8, 4)),
)
NARROW_WIDTH = CLASSES[0].width
MAX_WIDTH = CLASSES[-1].width


def class_of(width: int) -> WidthClass:
    """The row of a width (of D, or of the largest of D, G and O): the first
    class that holds it (the last past all three, which the gates refuse)."""
    return next((c for c in CLASSES if width <= c.width), CLASSES[-1])


def width_class_of(width: int) -> int:
    """The width class of a width: 128, 256 or 512 (``class_of``)."""
    return class_of(width).width
