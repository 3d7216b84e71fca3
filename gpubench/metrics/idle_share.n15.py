"""idle_share.n15: idle_share.lat in the logn=15 cells, whose end-to-end metrics (.n15)
carry their own bounds."""

from gpubench import harness

read = harness.load_module("metrics", "idle_share.lat").read
