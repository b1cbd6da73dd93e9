"""device.idle_share.fused: device.idle_share (see device.idle_share.py) in the cells that report overall_s."""
from pathlib import Path

from perfbench.harness import load_reader

read = load_reader(Path(__file__).with_name("device.idle_share.py"))
