"""Float64 NumPy / SciPy implementations of the reference's DSP and meter:
the ``backend="oracle"`` arms of ``compat`` and ``analysis.metrics``."""
