"""One module per assigned architecture (exact public-literature configs).

Selectable via ``--arch <id>`` through :mod:`repro_torch.config.registry`.
"""
