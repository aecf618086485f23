"""Host-side tools of the port, each run as `python -m fusionmamba_torch.tools.<name>`:
`color_convert` (Y <-> RGB over folders) and `check_dataset` (label-class audits)."""
