"""Domain-randomization evaluation profiles (a copy of the JAX package's
``learn/domain_randomization_profiles.py``, so that the port imports none
of it).

Port of ``go1_gym_learn/eval_metrics/domain_randomization.py``: named cfg
mutators used to evaluate policies under standard DR regimes (base_set,
rand_regular, rand_large, static_low/mid/high).  ``train.py --dr_profile``
applies ``rand_regular`` or ``rand_large`` to a training configuration;
``eval.py --dr_profile`` / ``--dr_sweep`` evaluate under any of them.
"""

from __future__ import annotations


def base_set(cfg):
    cfg.terrain.teleport_robots = True
    cfg.terrain.border_size = 50
    cfg.terrain.num_rows = 10
    cfg.terrain.num_cols = 10
    cfg.commands.resampling_time = 1e9
    cfg.env.episode_length_s = 500
    cfg.rewards.terminal_body_height = 0.0
    cfg.rewards.use_terminal_body_height = True
    return cfg


def _common(cfg):
    cfg.domain_rand.randomize_restitution = True
    cfg.domain_rand.restitution_range = [0.0, 1.0]
    cfg.domain_rand.restitution = 0.5
    cfg.domain_rand.randomize_Kp_factor = False
    cfg.domain_rand.Kp_factor_range = [0.8, 1.3]
    cfg.domain_rand.randomize_Kd_factor = False
    cfg.domain_rand.Kd_factor_range = [0.5, 1.5]
    cfg.domain_rand.push_robots = False
    cfg.domain_rand.push_interval_s = 15
    cfg.domain_rand.max_push_vel_xy = 1.0
    return cfg


def rand_regular(cfg):
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = [0.05, 4.5]
    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = [-1.0, 3.0]
    cfg.domain_rand.randomize_com_displacement = True
    cfg.domain_rand.com_displacement_range = [-0.1, 0.1]
    cfg.domain_rand.randomize_motor_strength = True
    cfg.domain_rand.motor_strength_range = [0.9, 1.1]
    return _common(cfg)


def rand_large(cfg):
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = [0.04, 6.0]
    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = [-1.5, 4.0]
    cfg.domain_rand.randomize_com_displacement = True
    cfg.domain_rand.com_displacement_range = [-0.13, 0.13]
    cfg.domain_rand.randomize_motor_strength = True
    cfg.domain_rand.motor_strength_range = [0.88, 1.12]
    return _common(cfg)


def _static(cfg, friction, added_mass, com, strength):
    cfg.domain_rand.randomize_friction = True
    cfg.domain_rand.friction_range = friction
    cfg.domain_rand.randomize_base_mass = True
    cfg.domain_rand.added_mass_range = added_mass
    cfg.domain_rand.randomize_com_displacement = True
    cfg.domain_rand.com_displacement_range = com
    cfg.domain_rand.randomize_motor_strength = True
    cfg.domain_rand.motor_strength_range = strength
    return _common(cfg)


def static_low(cfg):
    return _static(cfg, [0.05, 0.06], [-1.0, -0.99], [-0.1, -0.099], [0.9, 0.901])


def static_mid(cfg):
    return _static(cfg, [2.2, 2.3], [1.0, 1.01], [0.0, 0.001], [1.0, 1.001])


def static_high(cfg):
    return _static(cfg, [4.4, 4.5], [2.99, 3.0], [0.099, 0.1], [1.099, 1.1])


DR_PROFILES = {
    "base_set": base_set,
    "rand_regular": rand_regular,
    "rand_large": rand_large,
    "static_low": static_low,
    "static_mid": static_mid,
    "static_high": static_high,
}
