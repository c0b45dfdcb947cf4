"""Device-busy milliseconds a statement inside the device intervals of the
program's ``op.join`` spans (binary and multiway joins), read as
``agg_device_ms`` reads ``op.agg``."""

from gpubench.metrics.agg_device_ms import op_device_ms


def read(run):
    return op_device_ms(run, "op.join")
