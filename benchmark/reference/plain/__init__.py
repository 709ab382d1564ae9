"""The reference's env and policy, in plain PyTorch.

The env (configuration tree, tunnel and velocity envs, actuator net,
rewards, gait curriculum, terrain, observations) follows the modules of
``legged_tracking_torch`` that the two benchmark configurations run, taken
at the commit that added the benchmark.  What decides the physics is its
own: ``physics/engine.py`` solves every substep with the dense composite
formulation of ``physics/dynamics.py`` (the 18 x 18 mass matrix and its
explicit inverse, in float64), where the program runs its arrow-structure
solver; the height scan is the plain gather (no CUDA kernel); nothing is
set at import (``benchmark/reference/train.py`` sets the precision).  The
policies, by the name a configuration gives (``learn.POLICIES``), are
``learn/actor_critic.py``'s CSE MLP and ``learn/actor_critic_cnn.py``'s
conv + GRU policy; the learner is ``benchmark/reference/learner.py``.  The subpackages keep their relative
imports, so nothing here imports the program.
"""
