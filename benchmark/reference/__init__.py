"""The benchmark's plain reference: ``plain/`` (the env, its physics on the
dense rigid-body formulation, and the policies), ``learner.py`` (the
rollout, GAE and PPO update as formulas) and ``train.py``, which builds it
and follows the program.  Nothing here imports the program."""
