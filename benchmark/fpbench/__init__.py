"""The benchmark harness of the PyTorch/CUDA pose engine: the generic run of
a cell (``cell``), the profiler trace's reduction (``trace``), the spans and
patches placed round the engine (``spans``), and what the pose traffic kinds
of ``kinds/`` share: the engine, its recorder and client (``pose``), the
scene and frames (``scene``, ``traffic``), the judge (``judge``) and the
faults that test it (``faults``)."""
