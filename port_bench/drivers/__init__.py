"""Drivers: how a traffic mix drives the program's entry point, found by
the mix's ``driver`` key (``drivers/<driver>.py``, a class ``Driver``)."""
