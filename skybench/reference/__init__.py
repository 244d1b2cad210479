"""The benchmark's plain reference: NumPy and plain PyTorch, frozen here so
that no later change to the program moves the yardstick.

It imports nothing of the program under test.  ``tables`` holds the
galaxy profile tables, ``support`` the support-radius rule, ``renderer``
the expected-count image of a scene (the counts are drawn from it),
``posterior`` the dense (untiled) joint log posterior, ``whiten`` the
pooled moments and the whitening map, and ``diagnostics`` the effective
sample size and split-R-hat.
"""
