"""replay_host_ms: host milliseconds of one request inside the engine
programs' calls (copies into a graph's static inputs, the replay, the clones
of its outputs), the port's replay.* spans of the op-traced request."""

from gpubench import programtrace


def read(r):
    return programtrace.span_ms("replay.", "host")
