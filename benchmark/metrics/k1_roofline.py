"""K1 (``allpairs_kernel``) against its roofline, %: the least time for a
rank's targets against every source (``benchmark.roofline``) over the
mean device time of a K1 launch in the traced runs."""

from benchmark.roofline import allpairs_bound_s


def read(r):
    if r.trace is None or r.sm_clock_hz <= 0:
        return None
    times = r.trace.kernel_durations(
        lambda base, name: base == "allpairs_kernel")
    if not times:
        return None
    n = int(r.config["n_bodies"])
    bound = allpairs_bound_s(n // int(r.config.get("devices", 1)), n,
                             int(r.config["n_dim"]), r.sm_clock_hz)
    return 100.0 * bound / (sum(times) / len(times))
