"""Window drivers, one file a way of driving an entry point, named by a
configuration's "driver".  Each defines ``Driver(cfg, mix, seed, work,
device, cache, control=False, trace=False)`` with ``setup()`` (load and
warm up), ``step(i) -> units`` (one unit of the window's work),
``free()`` (write what is judged, drop the port's state), ``judge(limits)
-> (numbers, failed units)`` and ``readings`` (what the metric readers
read)."""
