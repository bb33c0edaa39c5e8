"""The width classes of the forwards #1, #3 and #5 and of the loop backward
#4: one table, one row a class, that every plan, gate and choice of a build
reads.

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
  past 256;
- ``backward_tall_max_n``: the largest N of #4's narrow and tall builds
  (``kTallMaxN`` of ``csrc/scann_loop_backward.cu``), the wide build taking
  the rest: 32 (``kbwd.MAX_CHUNK_ROWS``) up to 256 columns; past 256 16,
  since a tall chunk holds whole atoms and 32 rows take 339,968 bytes at
  D = 384 with atom blocks of 8;
- ``tall_backward`` and ``wide_backward``: #4's tall chunks and wide
  sub-chunks, the (rows, atom blocks) its plan tries in order, the first
  that fits a block's shared memory taken (``_backward_plan`` of
  ``kernels/scann_loop.py``, ``kTallChunkRows`` and ``build_plan`` of the
  CUDA source). Up to 128 columns 64-row chunks and sub-chunks; past 128
  the first of 64, 32 and 16 rows a tall chunk, and 64-row sub-chunks at
  blocks of 8 atoms or more, else 32; past 256 16 rows each, with atom
  blocks down to 2 and 1 (a 16-row chunk takes 223,744 bytes at D = 512
  with blocks of 2, and the wide build 230,912 at N = 256 with blocks of
  1: the eight warps' LayerNorm partials, 2 x 8 x 512 floats, and the five
  [block, 512] slots leave no room for more).
"""

from typing import NamedTuple, Tuple

Chunks = Tuple[Tuple[int, Tuple[int, ...]], ...]


class WidthClass(NamedTuple):
    width: int
    suffix: str
    chunk_rows: int
    narrow_max_n: int
    tall_max_n: int
    wide_forward_rows: int
    atom_blocks: Tuple[int, ...]
    backward_tall_max_n: int
    tall_backward: Chunks
    wide_backward: Chunks


_BLOCKS = (32, 16, 8)       # #4's atom blocks up to 256 columns (ATOM_BLOCKS)
_WIDE_BLOCKS = _BLOCKS + (4,)
_D512_BLOCKS = _WIDE_BLOCKS + (2, 1)

CLASSES = (
    WidthClass(128, "", 64, 64, 64, 64, (64, 48, 32, 16), 32,
               ((64, _BLOCKS),), ((64, _WIDE_BLOCKS),)),
    WidthClass(256, "_d256", 32, 64, 32, 32, (64, 48, 32, 16, 8), 32,
               ((64, _BLOCKS), (32, _BLOCKS), (16, _BLOCKS)),
               ((64, _BLOCKS), (32, _WIDE_BLOCKS))),
    WidthClass(512, "_d512", 16, 16, 16, 16, (64, 48, 32, 16, 8, 4), 16,
               ((16, _D512_BLOCKS),), ((16, _D512_BLOCKS),)),
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
