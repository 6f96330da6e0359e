"""The paper's own experimental setup (§III, §V).

N=6 workers, G=6 sub-matrices, J=3 replication, speed vector
s=[1,2,4,8,16,32]; 6000x6000 matrix for power iteration (§V). A copy of
:mod:`repro.configs.usec_paper`.

``ROWS_PER_SECOND`` scales the speed vector to the rows per second the
port's synthetic clocks take (``SyntheticSpeedClock``); ``BLOCK_ROWS`` is the
executor work unit the card runs the §V grid at (it divides the 1000-row
cyclic and 300-row MAN tiles).
"""

import numpy as np

N_MACHINES = 6
N_TILES = 6
REPLICATION = 3
SPEEDS = np.array([1.0, 2.0, 4.0, 8.0, 16.0, 32.0])
MATRIX_DIM = 6000
PLACEMENTS = ("repetition", "cyclic", "man")

ROWS_PER_SECOND = 1000.0
BASE_SPEEDS = tuple(float(s) * ROWS_PER_SECOND for s in SPEEDS)
BLOCK_ROWS = 20
