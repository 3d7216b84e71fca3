"""replay_host_ms.n15: replay_host_ms in the logn=15 cells, whose end-to-end
metrics (.n15) carry their own bounds."""

from gpubench import harness

read = harness.load_module("metrics", "replay_host_ms").read
