"""bootstrap_dev_ms.coeff2slot.n16: bootstrap_dev_ms.coeff2slot in the logn=16 cell, whose
end-to-end metrics are the shared ct_per_s and latency_p50_ms, not the .n15
ones."""

from gpubench import harness

read = harness.load_module("metrics", "bootstrap_dev_ms.coeff2slot").read
