"""The reader of `dots_row_tile.b4096`: the mean batch rows of a dots
block over the traced stretch's `dots.row_tile.<r>` counts, chained loop
only, None where the program counts none (as a program without the
counter); the manifest reports it in the three batch-4096 cells."""

from __future__ import annotations

import types

import pytest

from benchmark.run import Manifest, load_reader

B4096 = ("cggi128.nand_b4096", "mk2.nand_b4096", "fast128.nand_b4096")


@pytest.mark.parametrize("launches,loop,want", [
    ({"dots.row_tile.128": 3, "dots.per_sm.1": 3, "dots.clustered": 3},
     "chained", 128.0),
    ({"dots.row_tile.64": 8, "dots.per_sm.2": 8}, "chained", 64.0),
    ({"dots.row_tile.64": 1, "dots.row_tile.128": 3}, "chained", 112.0),
    ({"dots.per_sm.1": 4, "dots.clustered": 4}, "chained", None),
    ({}, "chained", None),
    ({"dots.row_tile.64": 630}, "closed", None),
])
def test_row_tile_reader(launches, loop, want):
    run = types.SimpleNamespace(loop=loop, launches=launches)
    assert load_reader("dots_row_tile.b4096").read(run) == want


def test_the_b4096_cells_report_it():
    man = Manifest.load()
    for cell in B4096:
        assert "dots_row_tile.b4096" in \
            {m["name"] for m in man.metrics(cell, True)}
    for cell in ("cggi128.nand_b1", "mk2.nand_b1"):
        assert "dots_row_tile.b4096" not in \
            {m["name"] for m in man.metrics(cell, True)}
