"""Default configuration.

Mirrors the reference's yacs config tree (reference codes/config/default.py:1-56)
key-for-key so the reference's shipped YAML files (e.g. codes/config/nef_net.yml)
load unchanged, plus the JAX package's TPU group (same keys, same defaults) so
one config file drives both packages.
"""

from electrocardio_panorama_tpu_torch.config.node import Node


def get_default_cfg() -> Node:
    cfg = Node()
    cfg.seed = 123
    cfg.fit_msg = "None"
    cfg.output_dir = "output"
    cfg.latent_save_dir = "output/latents"
    cfg.desc = "model_v2_tianchi"

    # ------------------------------------------------------------------ DATA
    # reference codes/config/default.py:14-27
    cfg.DATA = Node()
    cfg.DATA.dataset = "tianchi"
    cfg.DATA.train_label_path = "data/tianchi/tianchi_train_jsons.txt"
    cfg.DATA.test_label_path = "data/tianchi/tianchi_test_jsons.txt"
    cfg.DATA.train_data_root = "data/tianchi/npy_data/tianchi_train_round1"
    cfg.DATA.train_label_root = "data/tianchi/tianchi_interval"
    cfg.DATA.train_pkl_path = "data/PTB/pkl_data/train_heartbeats.pkl"
    cfg.DATA.test_pkl_path = "data/PTB/pkl_data/test_heartbeats.pkl"
    cfg.DATA.noise_std = [
        4.37258895, 4.73799667, 5.00643047, 6.7582663,
        6.57354042, 6.31023917, 6.05944371, 7.05612394,
    ]
    cfg.DATA.lead_num = 1
    cfg.DATA.in_channel = 8            # model_resnet1d, model_st_mem_vit: leads of a record (Tianchi: 8)
    # tianchi_cls records as the model takes them: "raw" (the 8 stored leads
    # at 500 Hz) or "12lead_250hz" (data/tianchi.py::twelve_leads_250hz)
    cfg.DATA.cls_input = "raw"
    cfg.DATA.noise = False
    cfg.DATA.train_data_mode = "normal"
    cfg.DATA.super_mode = "normal"
    cfg.DATA.weighted_sample = False
    cfg.DATA.synthetic_root = ""       # non-empty => root for the synthetic corpus
    cfg.DATA.synthetic_n_train = 16    # corpus size when generating synthetic data
    cfg.DATA.synthetic_n_test = 8
    cfg.DATA.use_native_prep = True    # C++ beat-prep fast path (falls back to numpy)
    cfg.DATA.record_cache = 2048       # LRU'd record arrays (~320 KB each); 0 disables
    cfg.DATA.beat_cache = 8192         # LRU'd prepped beats (~25 KB each); 0 disables
    cfg.DATA.batch_size = 32           # reference hardcodes 32 (train_net.py:27)
    cfg.DATA.num_workers = 0           # host pipeline threads (0 = synchronous)

    # ----------------------------------------------------------------- MODEL
    # reference codes/config/default.py:33-38
    cfg.MODEL = Node()
    cfg.MODEL.model = "modelv2"
    cfg.MODEL.resume = ""
    cfg.MODEL.loss = "v1"
    cfg.MODEL.jitter_factor = 0.0
    cfg.MODEL.theta_L = 1
    # model_resnet1d, the reference's 1-D ResNet classifier (resnet_1d.py)
    cfg.MODEL.arch = "resnet50"        # model_st_mem_vit: "vit_base"
    cfg.MODEL.num_classes = 55

    # ---------------------------------------------------------------- SOLVER
    # reference codes/config/default.py:44-55
    cfg.SOLVER = Node()
    cfg.SOLVER.optim = "sgd"
    cfg.SOLVER.scheduler = "steplr"
    cfg.SOLVER.lr_step = [150, 350]
    cfg.SOLVER.lr = 1e-3
    cfg.SOLVER.epochs = 500
    cfg.SOLVER.OurLoss1_version = "v2"
    cfg.SOLVER.reg_loss = "l1_loss"
    cfg.SOLVER.loss_using = [1, 2, 3]
    cfg.SOLVER.part_loss_no_grad = False
    cfg.SOLVER.loss_factor = [1, 1, 1]

    # ------------------------------------------------------------------- TPU
    # The JAX package's execution group, kept key-for-key so every config
    # (e.g. configs/dense_sweep_v5e8.yml) loads unchanged in both packages.
    # The port reads param_dtype and compute_dtype ("float32" | "bfloat16"),
    # steps_per_epoch, profile_dir (a torch.profiler trace), check_nans,
    # eval_decoder, train_decoder, train_encoder, encoder_ckpt and
    # eval_encoder (training/solver.py).
    # mesh_shape non-empty and checkpoint_backend 'orbax' raise
    # NotImplementedError until their slices land (ROADMAP.md).
    cfg.TPU = Node()
    cfg.TPU.mesh_shape = []
    cfg.TPU.mesh_axes = ["data"]
    cfg.TPU.param_dtype = "float32"
    cfg.TPU.compute_dtype = "float32"
    cfg.TPU.steps_per_epoch = 0
    cfg.TPU.profile_dir = ""
    cfg.TPU.check_nans = True
    cfg.TPU.checkpoint_backend = "pickle"
    cfg.TPU.eval_decoder = "auto"
    cfg.TPU.train_decoder = "xla"
    cfg.TPU.train_encoder = "auto"
    cfg.TPU.encoder_ckpt = "tower"
    cfg.TPU.eval_encoder = "xla"
    # accepted without effect: the port draws its dropout masks from a
    # torch.Generator per step, seeded from (seed, epoch, step)
    cfg.TPU.rng_impl = "rbg"
    return cfg
