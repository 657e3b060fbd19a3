"""Traffic drivers, one module per driver a traffic file names:
``setup(run)``, ``window(run, state)``, ``release(run, state)`` and
``check(run, state)``."""
