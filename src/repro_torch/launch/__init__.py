"""Launchers (port of ``repro/launch``): ``serve``, ``train``, ``mgmark``
and ``mesh.make_mesh``."""
