"""load_s: host clock around pyrhe_tpu_torch.core.data.load_dataset in
set-up."""


def read(run):
    return run.load_s
