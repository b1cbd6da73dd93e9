"""pcg.iters.fused: pcg.iters (see pcg.iters.py) in the cells that report overall_s."""
from pathlib import Path

from perfbench.harness import load_reader

read = load_reader(Path(__file__).with_name("pcg.iters.py"))
