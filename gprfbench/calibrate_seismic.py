"""``calibrate.py`` with the faults of ``faults.py`` planted on the seismic
loss's own binding as well: ``fused_seismic`` imports ``gprf_ll_schur``
itself, so ``half_the_batch`` (planted on ``gprf_torch.model.fused``)
misses it; ``half_the_batch_seismic`` is the same wrapper on
``gprf_torch.model.fused_seismic``.

    python3 -m gprfbench.calibrate_seismic --workload seismic12k.multistart4 --seconds 25 \\
        --seeds 11 12 13 --fault half_the_batch_seismic
"""

from __future__ import annotations

import sys

from gprfbench import calibrate, faults

FAULTS = {"half_the_batch_seismic": ("gprf_torch.model.fused_seismic", "gprf_ll_schur",
                                     faults._half_the_terms)}


def main(argv=None):
    faults.FAULTS.update(FAULTS)
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
