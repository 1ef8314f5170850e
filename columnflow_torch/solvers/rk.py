"""The Dormand-Prince 4(5) tableau and Hairer's CONTD5 dense-output
weights, as Python floats (port of ``DOPRI5`` and ``DOPRI5_DENSE_D`` in
``columnflow/solvers/rk.py``; the other tableaus are not ported yet).

The fused dopri5 solver multiplies float32 step sizes by these numbers, so
each is rounded to float32 once where it is used, as a weak-typed Python
scalar is in the JAX package.
"""

from __future__ import annotations

N_STAGES = 7

# Stage times.
C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)

# Stage weights, strictly lower triangular (FSAL: row 6 equals B).
A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)

# Fifth-order solution weights and the embedded fourth-order ones.
B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B_HAT = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
# Error-estimate weights b - b_hat.
B_ERR = tuple(b - bh for b, bh in zip(B, _B_HAT))

# Dense-output weights of the 4th-order interpolant (stage 1 does not
# contribute).
DOPRI5_DENSE_D = (
    -12715105075 / 11282082432,
    0.0,
    87487479700 / 32700410799,
    -10690763975 / 1880347072,
    701980252875 / 199316789632,
    -1453857185 / 822651844,
    69997945 / 29380423,
)
