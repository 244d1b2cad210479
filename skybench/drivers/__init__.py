"""Sampler arms, one module each: ``drivers/<arm>.py`` defines ``Arm``,
which a traffic file names by its ``arm`` key."""
