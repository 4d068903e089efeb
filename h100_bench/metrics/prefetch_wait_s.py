"""prefetch_wait_s: Engine.phase_times["prefetch_wait_s"] per estimate,
averaged over the window's estimates: host seconds the engine's main
thread spends blocked on the prefetch thread's next block, inside its
`pyrhe.prefetch_wait` spans (Engine._blocks), over both passes."""


def read(run):
    return run.mean_phase("prefetch_wait_s")
