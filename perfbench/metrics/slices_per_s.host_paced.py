"""``slices_per_s`` as a per-layer reading, for a cell whose step the host
paces: there the rate follows the load on the machine's shared CPU cores
and spreads too widely from run to run for a bound."""

from pathlib import Path

from perfbench.manifest import reader

read = reader("slices_per_s", Path(__file__).resolve().parent.parent)
