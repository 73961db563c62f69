"""Traffic kinds: each module drives one kind of traffic. A traffic file
(``traffic/<name>.json``) names its kind; the kind's module makes the run's
inputs from the seed and the file's parameters (``make_inputs``), drives the
system under test one call at a time (``Client``), and judges the calls
against the plain reference (``judge``, ``summarize``)."""
