"""The port's counterparts of the reference's ``tools/`` scripts
(``python -m repro_torch.tools.<name>``); nothing runs at import."""
