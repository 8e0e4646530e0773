"""Observability (the port's own copy of part of ``delta_tpu.obs``):

* :mod:`delta_tpu_torch.obs.scan_report` — per-query data-skipping reports
* :mod:`delta_tpu_torch.obs.router_audit` — routed decisions priced against
  what ran
* :mod:`delta_tpu_torch.obs.calibration` — EWMA re-fit of the link cost
  constants

The doctor, the HTTP endpoint, the flight recorder, the journal and the
advisor are not ported.
"""
from delta_tpu_torch.obs.scan_report import ScanReport, last_scan_report

__all__ = ["ScanReport", "last_scan_report"]
