from codon_tpu_torch.serve.export import export_forward, load_exported  # noqa: F401
