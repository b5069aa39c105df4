import time

T0 = time.perf_counter()

import sys  # noqa: E402

from gpubench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], T0))
