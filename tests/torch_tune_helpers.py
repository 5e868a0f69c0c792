"""Shared by the port's Tune test files: a bounded fit. Imports neither
ray_tpu nor jax (workers may import the test modules that use it)."""

import threading


def fit_bounded(fit, timeout: float = 90.0):
    """``fit()`` (a Tuner's fit or tune.run) within ``timeout`` seconds: a
    trial that never schedules fails the test instead of hanging it."""
    box = {}

    def run():
        try:
            box["grid"] = fit()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout)
    assert not th.is_alive(), f"fit did not finish in {timeout} s"
    if "error" in box:
        raise box["error"]
    return box["grid"]
