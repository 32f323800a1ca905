"""setup_s: seconds from process start to the first timed request or step
(imports, the kernel library, the seeded weights, the warm-up), on the
host's clock."""


def read(run: dict):
    return run["setup_s"]
