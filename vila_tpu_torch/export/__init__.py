from vila_tpu_torch.export.hf_remote import export_hf_repo  # noqa: F401
