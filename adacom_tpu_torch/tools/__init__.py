"""Measurement tools of the port: the ClickBench suite runner and the
decode-scan roofline (``python3 -m adacom_tpu_torch.tools.<name>``)."""
