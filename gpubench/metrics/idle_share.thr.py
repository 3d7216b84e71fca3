"""idle_share.thr: idle_share.lat in a cell whose end-to-end metric is the
rate."""

from gpubench import harness

read = harness.load_module("metrics", "idle_share.lat").read
