import time

_T0 = time.perf_counter()

from skybench.run import main  # noqa: E402

raise SystemExit(main(t0=_T0))
