"""``engine_python_idle_ms``: the device's idle time a traced step while the
host ran the epoch engine's own Python, in ms: the idle gaps whose innermost
host range is one of the engine's ``lcc.*`` spans (``repro_torch.obs.trace``),
with no torch operator or CUDA call under way, summed over the traced window
and divided by its steps. Nothing to read where the program opens no such
span, or where the device ran nothing."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.step_s:
        return None
    engine = [s for name, s in t.idle_by_host.items()
              if name.startswith("lcc.")]
    if not engine:
        return None
    return 1e3 * sum(engine) / len(run.step_s)
