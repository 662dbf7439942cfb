"""The one way the port refuses what it does not cover yet."""


def unported(what: str, item: str):
    """Raise NotImplementedError naming the ROADMAP.md item that ports it."""
    raise NotImplementedError(
        f"{what} is not ported to rl_games_tpu_torch yet (ROADMAP.md, item {item})"
    )
