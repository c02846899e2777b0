"""A cell of the manifest cut to a CPU test's size (nf 32, 16^3, two
levels, 50 scales, the generated lattice's mask)."""

import copy

from portbench import harness

TINY_MODEL = dict(nf=32, ch_mult=[1, 2], num_res_blocks=1, num_res_blocks_first=1,
                  attn_resolutions=[8], num_scales=50)


def tiny_config(cfg: dict, R: int = 16) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg['model'].update(TINY_MODEL)
    cfg['data']['image_size'] = R
    cfg['tet_file'] = ''
    return cfg


def tiny_cell(name: str = 'gen64-b4', batch: int = 2) -> harness.Cell:
    cell = harness.Cell.load(name)
    cell.config = tiny_config(cell.config)
    cell.traffic = dict(cell.traffic, batch=batch, warmup_steps=1, check_steps=1,
                        check_within=3, trace_at=2, trace_steps=2, trace_tries=1)
    return cell
