"""Run scripts of the port (twins of the reference's `scripts/`):

- scripts/train_north_star.py  the skill run: train against the fake
                               env's hard bot until the agent's anchored
                               TrueSkill clears it;
- scripts/chaos_soak.py        the closed-loop soak under seeded faults
                               and broker kills, with conservation checks.
"""
