"""``engine_idle_share``: the share of the traced window in which the device
was idle while the host was inside a step's program call: every idle gap but
those whose innermost host range is the harness's own window or step range,
over the window. With the engine's ``lcc.epoch`` span around the whole call,
this is the part of ``device_idle_share`` that the program, not the harness,
leaves. Nothing to read where the program opens no ``lcc.*`` span, or where
the device ran nothing."""
from gpubench.devtrace import STEP, WINDOW


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    if not any(name.startswith("lcc.") for name in t.idle_by_host):
        return None
    idle = sum(s for name, s in t.idle_by_host.items()
               if name not in (WINDOW, STEP))
    return idle / t.window_s
