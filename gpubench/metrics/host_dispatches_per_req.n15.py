"""host_dispatches_per_req.n15: host_dispatches_per_req in the logn=15 cells, whose end-to-end metrics (.n15)
carry their own bounds."""

from gpubench import harness

read = harness.load_module("metrics", "host_dispatches_per_req").read
