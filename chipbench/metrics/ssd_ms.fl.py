"""Device ms a round spends in the Mamba-2 SSD scan: the device_ms of the
program's model.ssd_fwd spans (both forwards of each remat'd block) and
model.ssd_bwd spans (the kernels' backward) of every local step, over the
window's rounds.  A program without these spans gives None."""
import program_spans

UNIT = "ms"


def read(record):
    return program_spans.device_ms_per_unit(record, ("model.ssd_fwd",
                                                     "model.ssd_bwd"))
