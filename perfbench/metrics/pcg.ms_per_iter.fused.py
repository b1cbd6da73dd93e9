"""pcg.ms_per_iter.fused: pcg.ms_per_iter (see pcg.ms_per_iter.py) in the cells that report overall_s."""
from pathlib import Path

from perfbench.harness import load_reader

read = load_reader(Path(__file__).with_name("pcg.ms_per_iter.py"))
