"""``python -m repro_torch.cluster.runtime HOST PORT [--device D]`` -- run one worker process."""

import sys

from .worker import main

main(sys.argv)
