"""engine_init_s: Engine.phase_times["engine_init_s"] per estimate,
averaged over the window's estimates: host seconds of Engine.__init__,
the engine's `pyrhe.engine_init` span (the cache plan, the static device
arrays, the host cache and the leave-one-out counts)."""


def read(run):
    return run.mean_phase("engine_init_s")
