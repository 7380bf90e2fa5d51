"""AAC / SBR specification data tables (GENERATED — do not edit).

Generated by support/extract_aac_tables.py from the system
libavcodec.a (ISO/IEC 13818-7 + 14496-3 data tables carried in
aactab.o / aacdec.o / aacsbr.o).  Spec tables, not code.
"""

import base64
import zlib

import numpy as np

_RAW = zlib.decompress(base64.b64decode(
    "eNqtewdYFFfU9h0GGJYFBsEedey9xs7uzLFXNPZC1NgLKoIFscBq7CW22HvUxN5jlIWdazf2"
    "AmJFFOm99/Kduwsm5k/+5/mf7x+ed2fmzsyde855T1k9G1fKkxhELCIakV0qkHREMiIHkYJI"
    "RaQhihDFiFJECSIXkYcoROQjovD5Atx/xn1qKYfPcDgfwTk4koH7TEQWIh2RYyAkF5EPhGQj"
    "chGZiBxEBjuXcByRL+IxIgeRL+DzuM/DfT6P44hsRB6Hx4gCgseIHMQihBuiE6I6QouwJpbN"
    "HuGA+AbRGaFD+CEWI3IR+WwOnC8fkYXz57B3sHex9yNyELmIbLYWRBauMweRx4Brz0KkMVlR"
    "vhzcZ+M+EnXyBnXzFvEO8R4RjviAeI14gQhBhCJeIsIQGYgIRCwiDhGPSEAkImIQHxGfEJFm"
    "nTP9C2hDgbxCJCGyEJkIF9xcv95cXF0qVHCu4IybKDqZN0dHBwcHrYPW3t5eo7GzsxNsbW2s"
    "ec7a2sbWVhDs7DQavKLFzcHB0dHRyclZdBb/Oe0/tsHkr78u+HcS/+pweUI6Vyxk89NJGp8r"
    "JHHZQjo/FxU9n1QgviSRm4UKLxI+celCGjcBDZEhJHCFQgY3gyRzC0kVMofEcJNJNDeNVCIT"
    "iQsaqyKZQiqT2SSem0SiuJnElfiQz5w3yeRKhFguU0jlxpMULk2I5AqETN6TxHELiDOZR7I4"
    "LyRRjvCRyxcy+KkkmysVcrksIZObQ4q5RFKPJCCx4kgBl0FaEG9Sm9iSZsSLNCbxSI6pSLZY"
    "JFE6zjMTn00iTcks0hzp1YhMQ9Jlk/rEjkhEgysUSE2kYGuSSmqQyaQW0q8JySStSBop4nxI"
    "BpdF6pAYJN90JHMKqYvytCFWpCFJJg2IJynk5pISlL8lUruUm20mpwbn0pJqOEMiF8Nl8Pak"
    "PUnl2pGOqIVkDqXmU7hkvkBK4jJQujwhj88T7dAdcvgOZAFJ5xP5JD5LrIoazxI6k/kklc/k"
    "srgcIY5L4IukDJLOFYrZfKZQJKagjkoMaWinYkOhVAClpelouSJI4FL4QsgRC8QiQ4aQLZaU"
    "ZqE9Cw25Yr5YYBDQIjmkKmogFdeViU5bDW2XjDbjSCSu2hvnSOHSSYGQQqJIBlohlS8WbNCW"
    "GSibNYkmWSQOWWGLeogl6H1kJvlMZqBNE1FTObwX6iWLS+LTuHw+mySRQiEBmZHL56OFS8V4"
    "ZEMePwv1mY2rRP0KuciyEjGZT0c5SpB9RUKplCtmCXE4niKghsRiqVhMF+L4OC6NJLGnhAIx"
    "S0zFp+NwtUkkDTWTKSQKiVwCWtcOdZ+CkiULaXwGcklrDiw+aNV4IVVI4VJRdg2yIxHtkSTk"
    "CImo32QyF5mTjnbJFXLENCGeT0YNJKAUeUK+WCQVidliAq4/g88WCsUSqUQoxvUmol0SuDSu"
    "CPWTw0fj22fhe9B70A9ycdZU8i0yrjGypQ2+DfmK7G2J67NGtjZBreFakD8tUI8E9dgK11qA"
    "/PBCJgtoCxtk7GyUNx951xoZ2xQZ1xalzeDy+ChcsSfKPgP5gZbiS4V8PgfZlcfFc9lcIeqQ"
    "4PMd8WoGspBJZY3Mbo+rS0LdpOA9HUg7lDkBn47nMrlsfh7OlogrT0d5kvgCPhMZEYfrS+XT"
    "+Xy+UEhGaRKQsZl8HlqySEjhk1B65BVqqFgsEXOYtvkcvkAoRmaWik74fmdc9xy2Pq6E581h"
    "3gVl8kSW5xERpbZFTrVEGeaiR7bCGOOKMn6LOkzChOGDWmiBepuN68pAn05FvbZFnXnh+vNJ"
    "EZ/HzUd9JeOKc9DrirliXHEW+mkuV8gVcRjTzfLHkg/cE/4N/6fwWPhTDBejpCTJogkmezKJ"
    "5J7zIfxH/rXwVHwpMp34ILeTyCfuKR/Ov+OfCffEUDFKjMFVxJNw7jP3gn/PPxIeCB+E12KC"
    "+E6KQNa/Rz9/yX/gHwrhwnvhsRgpxoqfpGf8Ry6KC+PvCM+Fd8IL8aPwRkwUP0vx0m0hmnvF"
    "3xWeCm+Fh+Jb8bMYL8ZImVKuFCK85j/xocIbIUT8IIZLb6RIKUFKl3KkF0Io/5a/J7wSIoUn"
    "4jvxtZQipUGWlAGfhAj+vhAmPBCfidFijJgopUqZkAXZ8FF8IrwU7orPxU/iRylOSpPSIQ9y"
    "oMgQJ0YI98VX4nvxvRQhJUvZUj4UQrGhxBArPRLDxAjxg/RWipYyMKrkQhEUQ6mhLjK3JnL5"
    "BxJCnnLP+Fd8Mp+G/lMsItmQrxqMwsPIePKSvCeh3GPUR6xQw2xlB4yrjcn35DF5Q55w77k3"
    "yKkG6Jf2xBF5PZJMII9IOHnEfeBC+Fh+LEZcCSN8IzIaI/JrEkFecJFcOJ/CPyfD0W9GkFGY"
    "XZ6Qjxit3nKh/Gc+UbjPjSMeZAyZRB6Qt+Qe94D7yL3j4/gkAS1GHpJn5BV5R+5yL7nX3APU"
    "Y4KQjnkslDwlYeQD+USecWHIhJfI4BShEL3/Mfcn95B7zr3iIpAJH/lUPgYjdYGYyIdzIdwb"
    "7h3y4BEyIYFPFjIxRuWLGcIT9MqH/Gs+jI/ko/k4IUvIxthWKBYISXwEWjWKj+HTeBaD8tBf"
    "mI8Q1E01IpP95C45zm3hb+J9MThfoZiE7yoRN/E2qFc79JKOpBvZRs6Trdyv3BXuIH+dP8I/"
    "5sOEcxi5BdR8VSyXupBN5Ci5RvZwZ7gb3EV+J6/yD/gDRI+RvTLGRR3pQbaSX4lKdnLnuEDu"
    "F34r/yvKvJ3sJR0w/7iRrmQj2UcukFvkIHeaC+YO8Zv5k/xT/mdCiUKAdCc9yUFynASS7dwR"
    "zsjd4n7jj/NBfCh/iBzmNpOfyBaym/xG/iC3ySHuPEe5PTzlf+fvo1VPkD+40+QYOUUukZvk"
    "DtnNHeOucRv5Y/xt/i76Whx/lpznt3EmEkw2cbu4vdxR7iL3E7+bv4oe+hx9MVz4nXzgT3L7"
    "uP3cL9wp7ix3mdvAX+Kv8U9Qux/5F0K0cJV8FoK4E9xv3AXuEneV28fv5Y38FbTJKyEKvTxB"
    "MJI44TBv4n7n1vO3uW38Kf4CH4xcDkXPfYfekibcwIz1J3+U38Ef4M/w5/g7aNNItF2UECt8"
    "FOLRpluw8vmZV7nr3HZ+F3+Wv8Xf4F/wb9FrIzALZQkFwg6spUz8fv40f4K/zAfyz5Cl0Xwk"
    "Ro1kZB6Lnz9zxeJ7/g/+HvLoIUaot3yI8ElIQXZko08xdhzgbnJXyC9kJ9lFdpA95DA5Qs5g"
    "nXaRXCZB5DrZzFkTrUZrL9hbPgUbQWM+1ggay6d5hH3acDZfjr9cNT+l+fKUffm4na2dBv9s"
    "BVsbhJ0GK0z2+dcIftrwCFvLSPlVLEzN91izcfYu8zhnbWdtw0pUa1uNra0GDzT2jhqNVmvv"
    "YG1rbytg6epgI2jxAAfxkp3GwV7rYGcvarSio5Oznb2Txt7JwUHUOjjba0U8wNlsrHF9Whvz"
    "gR0+aKe1s7PX2mvxkjWO2Nnjp7W1wNZjZy8I7JV2eA+Kae+An+YRtgDzp9bRgX1qHXCPU2nw"
    "7XjBTmBHWg2+AlevtbcTrDmc8a8Rbfk9X57CKh1LdNzjANvszbcI7CbUC9tQDagea2tUz78c"
    "lN9jeUpgEpXNw/G25lfxeB8r920tO/vy4r/8K4DGvGdLYzvzcphgDrhi8wTWPDsQUALL3tbG"
    "xjwVfqFgp/he8/cJew37ZHOZPzX2+H47jWUqR8eyRdib32D7t2MHpg/zbew+zV/HDo5sQezQ"
    "PIFWUzbMvq1oy6d1LD8xnzk5OpltYr4JvwI5WOYxH4sOZcd4IoqOX47xzNYsj+XrkEO5lOal"
    "21qXycpWhXLbfPnmxIT/cmLWgFl4pk6zGcwaYLq1sys//nJiX6Zts5nML7UvO7SIa28+tHw3"
    "09qXHTOhzAYpXygjnE35WsueNtumzAzmkXIj/TVgYcm/DJQvwc6yzC83fBkoP7dHU1tuLzvX"
    "2pUJU36utdP+7VxrHrA3+3C5XGzgy2Ye0Fj49+WcDXx1gxZd/O+nDg6a8pWWL9iGFYt2WDg4"
    "Y/Kril/NamOh0BiLx3aYznoQdyw0xmBxMAsL3KVkLdmOwfEMJo5HWHqkEWuuBteOG8TN4jZi"
    "GgjFcrCx1SirjVbXrQjfhV+GyZP9g8PX89c3z90FZx6Dsy4j//7+1pgmu5A+ZBCWIOPxPj+y"
    "ElPeYUyZt7FQSSN2XH2uCzeeW8YdxuTwkSNWta26WI23WmZ1GN/+Ed9fG1cwHtdw+B9rsKyg"
    "E8o2CGf2xhU0adKqTZu2rVo1a9ascWOkDOO3ZZOkuo2btm3ZsmnTpo0aoaqdvmzs31CsGn5Q"
    "azTsQz9uX0TH1FgKry6PBeNP9aFHzfMKu/4kZph6H56pVRdVpiZFoXid+vjNo8W7A+icuABo"
    "5+YLs5pMgXf93GHwwubQ7bYtnM66prxsrFfK5/+v+f7t/q2vnI0Xu7sadZc4Y+u9pYFn+xLj"
    "yXrWxk9WGqNhgGis/KqisUFsNWOz27WNsxY3MM6Z18z43Zk2xol57Y03juiMd1opxu/E7saf"
    "xvQwPh3T17h9WT/joB8GGJ+n9zcu3+puPPqjuzF2XH/jJE0fY+HknsbxEWA83UA2+o9ub2w5"
    "oqXxmtzQGBjxjVGOqGAc/dnW6LA8PfD+5bDAgs1XAw9F7gp8YjsmMO9klcAPvsuvNZo+saP8"
    "Y3SnF51HdE49urfzwG9COlf/bOOmbq7nlr28u1ufUxPcIn5e7tZtwc9u498fcxM6/+H22vOB"
    "W3SVcLctAWlu8YKVbstvDroNryvrUibW0XW92kz36bcOujV1uuoeFPbXZW8eoeu3dYLuTeFM"
    "XYK3r277omW6KjdX6V75r9cV9d+su1t/u274td066nxAt5//RRdU+1fdgXkndAdjT+vcO57X"
    "/bTrom7M88u6aX9e0XV0v6rr3/mazrHkmu7C3Ws67x9w73ZVt3HjFd1jz8u66TMv6FqZzui2"
    "jzuh2zzoqK7hrwd0N9/v1J1as1k3qfkaXQNhqW4ON13XZfAQnWm2m+7Hg7V1sz5Y6/ZFPXFr"
    "ELPJ7eTnqm4dtsR2bKqIxk6HdxlnzU0yDvu9blBx78FBYo3lQa1Me4M6DbsS9M7uedCWjOSg"
    "U9a2wYcOVwpeHNgguPaEDsG7j/YOdpo7Wl9yZ6b+2YEA/TqXdfq44m36rS0P6Gf/dFzfpeEl"
    "fb38YH1P6z/1S7uE6J2ufNCfH52gL2iWoy8ROLlzBUGu3dhRth3uKhesqiZXvS3J6UJDuat7"
    "c7n+4W/lkuROsn0nkE0BPeWzxv7yjPTBctVao2T31uPkqI6T5WF1PeU/iufIqy4ukL17LpGn"
    "TVgmr+NXyGu3r5JLxLXy2wXr5cjfN8qJEZvk2klb5F2vtsmnD26XQ5WdcuqNXbJ9xT1yZWWv"
    "7Cfvkz2c9suHTu+XH1Y7IPsMOSBPGH5APiIdkC+e2y//xO2Xj1TdJytJe+T3y3fLkc92ykmv"
    "tsuJe7bJUyptkbspP8nr66+XUy+ulodm/yiLD/zlQVYL5Do7ZsqJCyfInU6PkOs26i/PLVXk"
    "ZxW/lbPm1JcDK1WWJ5Tayh2VFP0Ax8f6hpNP6Y9VX63nr3bRH2kVpWuxjtN96jMkqKaXQ3Do"
    "0mnB6yOPBLdeHxLc55OVye5+DVPmzI6mOuFDTOmV5piSbFabbn/cbrKRjpluX7ts8rt4y1RZ"
    "E2qKDowy/XY327R9B69On+ugxi6upNqcq6Vet2usquvbqHPb6dQjfE/1ff5AdZ84Wg3vN0ld"
    "dXS2mlrTT630/XJVvbJa3V9zo7p921b1iOsutdPh/WqPjkfUqLDj6ullZ1XXby+rL+OvKWtP"
    "qMrTmbeVGm0fKPuLnyqXHr5UPPa+UxrN+KS4dIpVetgkK32eZSh3d+YpdFSJUlVrBb2jreF2"
    "sAB/bLaHwWMdIb2BM5TEusCcY5Wgz+iq0Er4BkadqQnn+taGiPC6sH16A2gW3whq/9AUdj9o"
    "Dg5NW0GOfxtIvtMWdKQD/NKiE/gPcIN74/RQOkGBaiO6wEW3bhAl9oD7oT3h17W9YXnzvvCn"
    "2g/Ogjs8OTcAVmm/g3kjBsGATYPh06Uh0OrOUOh8axj4nxsOg1eNgDt9RkJQ7kjosW0U7Kk6"
    "GjpuGA1OcaPhWGsPiJnsAZdXeMD+TZY9O2fj7Dq7j93PnmPPs3nYfGxeNj97D3sfey97P1sH"
    "Ww9bF1sfWydbL1s3Wz+Tg8nD5GLyMTmZvExuJj/TA9MH0wvTD9MT0xfTG9Mf0yPTJ9Mr0y/T"
    "M9M30zvTP7MDswezC7MPsxOzF7Mbsx+zI7MnsyuzL7MzszezO9rfzAPGB8YLxg/GE8YXxhvG"
    "H8YjxifGK8YvxjPGN8Y7xj/GQ8ZHxkvGT8ZTxlfGW8ZfxmPGZ8Zrxm8zz5HvjPeM/8wPmD8w"
    "v2D+wfyE+QvzG+Y/zI+YPzG/Yv7F/Iz5G/M75n/MD5k/Mr9k/sn8lPkr81vmv8yPmT8zv2b+"
    "zfyc+Tvze+b/LA6weMDiAosPLE6weMHiBosfLI6weMLiCosvLM6weMPiDos/LA6xeMTiEotP"
    "LE6xeMXiFotfLI6xeMbiGotvLM6xeMfiHot/LA6yeMjiIouPLE6yeMniJoufLI6yeMriKouv"
    "LM6yeMviLou/LA6zeMziMovPLE6zeM3iNovfLI6zeM7iOovvLM6zeM/iPsZ/cx5g+YDlBZYf"
    "WJ5g+YLlDZY/WB5h+YTlFZZfWJ5h+YblHZZ/WB5i+YjlJZafWJ5i+YrlLZa/WB5j+YzlNZbf"
    "WJ5j+Y7lPZb/WB5k+ZDlRZYfzXnyriVvsvzJ8ijLpyyvsvzK8izLtyzvsvzL8jDLxywvs/zM"
    "8jTL1yxvs/zN8jjL5yyvs/zO8jzL9yzvs/zP6gBWD7C6wFwfYJ3A6gVWN7D6gdURrJ5gdQWr"
    "L1idweoNVnew+oPVIaweYXUJq09YncLqFVa3sPqF1TGsnmF1DatvWJ3D6h1W97D6h9VBrB5i"
    "dRGrj1idxOolVjex+onVUayeYnUVq69YncXqLVZ3sfqL1WGsHmN1GavPWJ3G6jVWt7H6jdVx"
    "rJ5jdR2r71idx+o9VvfZfjBQx95Vaa/9fuAf0ZxWuuishHrNo9rTaSrXiqoRewfCiZBdypMd"
    "99SBA6dAzbXNg/t5NqPDjs2gE4sTTZ0mO4Dr1i6Q8vqR8kM3f7r4pIE6n5hAYfN8mhs4HaJr"
    "Jqj721SgbS670d9jFtMmu7uC3doRivznFnnDoD40/IoCqybPoPaffemNtXNp87v7FKNUrIrT"
    "m0Lmjw3gJ9UTGo9qqzi2ak/7rraF6GFtaaX6carmjwC6ZsdUWmnAEug6sBfdmq2lvfe/CK7i"
    "uT54+0y9rrfPGNrnzRtleVN/ei9/PO1ssIZ6w5vBM2cDXXKjIk1ONNCbIUvAfYkjrGtdFRSn"
    "i0qLqLlwcGZtCPJTaOiynrR4yVk1epEnnedURfbt1536xc+glbu5Q6UNXnTxPC3kVc8ybdZ/"
    "T0/Kb5QZ92bTer9vUnbeTzUt8TdQ74seykvddFrs0J1qphvAqekSaDlpAZXSvqfbmyyAsHAv"
    "+m2VYqVf5f1KrR3t6OyRHjDQJ1W5+2gGfNppoJ27+5jGVmsPxqlbleghF5XJ7+dB5moH6lan"
    "L90zvyvd12kBbVl3sFqQNwS2zVkIqREN6dgmk2gv4xw65LQBfnf0hFOHltCVHdpRl1WV4VDw"
    "Nd302rXgDDcZqtUWYFNoK3osfCD0VjtB/YFt6Imqdajveq0S12ePMvXPRLVzjifN95Pp9HYB"
    "0LDwmfL5/RDosVamP7RZSj8kG2i1DQvoUocAWgTfq1FN59DXLVvTvhfWqbXrzwSXE1S+lLiA"
    "Pgm5przuYA1uVzvQXwJqgP/ENGXGmAylQcYG9XjWdNi+ayEU7I1W3Av9IXhtUxjRcyHYPwY4"
    "VWUq1ccG0FV1BLg7ahEc39tctXFxg04uOarPwPnQu2trWPGnG61RqwdtvcqDzmw2CeZ5DqKl"
    "GxfRQdUnUMfvAdzdOlL9yKV06Yvh0L/3CBjXNkf93tGfVjvrB43tB4BNdRuoPGcAGOy0wet6"
    "9aBSVlt65poj/OC/gOasDFffr/IDjxJVrrhpFh0W4wG3UtvQKcuWwrnCNUqP8zrYuGmz0vND"
    "RaXJQ5na6gPg0c7NwUcNQ2mk5EgbtvSnJ+4thuiL3rR/uj/dsbUZlPZsQS+P4pQ6rYNkr4FD"
    "1JlzO9LFIxbTG1O+g7NrNLA8+6myYNUa9XO3FjQ8yQc+DB8HXsE6ddu1ALrh/qvggk8jwavu"
    "S7mTGmxSbb6F3p8N4FG92HS2pjtdPc+TJh73hX5TF8KA4+500On6MCYiyXRy3Dbl+bRH6r08"
    "b6h22h+anptJ9+zaphgdZtBeXYfTE2Ob0276+XDoj0LlfZWVpr31beQf4wNoPc0bJfRcIzpr"
    "8FCItxpEZze1plDVQK/2HwXHjup1a540gDbH28Ik78Fq4Hlf8J75TDk5sjWNCZkBdbZcUivl"
    "dYAKfjNhaLemsM3Xny588T187t8aNvo7QbVzAXTHiAHqrNY+4NjZQN9ub05fny9Wjo7PULsn"
    "fE93n3FRuvE+dP3bHerb6Jmyf+ePSpPSvrRvZaNao2JD+KHDZVOtiouhvrCQzq5nT+s1dILR"
    "OX2B66aHlwm+8LrRQbXjsoF0o5eLPLjRIrorcCm8eJurxEiD6euV06mbqQUcqDwIOn2qoz4d"
    "5AGRvw0E3Tf+6rmzWcr9zsmqz2Vf8HC8o6Q88acbvQ3q+gvDYPvRuTRgemWauHio/t3P8+G0"
    "7fe0n/VCej+qHu3XeBG1X14sNyiaAa+mV4SpTw20aUF7KJk6ji66/506cvRq9f2NlrT3lqWq"
    "PHY8LUi7o3d326AEVB0CdUNG0+nnJsJ4vyn0SBU3tX7MKvXYHioPmOYAAZlamnNlASy6bFL+"
    "GFeN2jduR3PXz4D0RhfV1K0BVOvcmv72Yq9q771OPX93GFTpUqh8kuPUA5vuKRkr50ONbovp"
    "iGGj5ZgZbdTWAbNpRrgBrDtUgubdG9JVQa2g1zc5Jhd3F/oktjJ96XlJTa8Spp463VARrxig"
    "Q4UoOcqmAr16ahrtX+INV4/9rrR+15XOHqWBn0YPUaxv+NB6mQboMcEdlnzargzveEWpnVib"
    "5i2+q4R7flCG9l5Kc44toae6jVT0z3or1l196M6Z8+m3z5ZAb8c50HlBe/qprQdNeXPK9BOM"
    "pQv8EtTlzveUOzaL4OKRmbAqVKKbu06Gk2ccYPmuYDU+xRfixnjDycFTqWPtABjzuZrJ+7E3"
    "lQ6FKDeGG6DuqOZqxSdX1eq3UlTPlSPkEb1XqFJSkLI/9o4a+osnPN+3Xx13rDV4hk2HRyl3"
    "VI/AAPjl1g419ipVrCpUp/GNxgFMXkQPZPtCC9+JcKWTK9zOGCbXfzxaWZFtR93S/GBQxWL1"
    "3uglUK+XP53g+kQ9UHkJNaxwoyfzNqhhEQb4U1kuOx/SUnHNYHXfjxXUBWubwPAznaFJ6Sha"
    "ZeRNfdP0SXSvYRK0WbEANi3sAaea6aHX0mqmCmuPqO1RRvXXc+rxT4+VH29kKY9f31fH/LoE"
    "MslRfeKag6r9N53VBoUGaLEFv8/5etGV55bQN48NsKLpADpVWaW229yNfvPmD9X1UE8l3GSg"
    "86oA1Ng5FkoHO8Euh9NK6JExcHahPxxdoZdvBjelm/d5Um1kPRjYpbayMSYAPAMTlLkT69Jj"
    "b0YqrmEHTFWGTaFk8lKoGjMBYhzxe9a5YHXkoT6QWhKnFA2/JLds9x1o5HF04IL7yrYKD1Sd"
    "XTP68+bFsHplZ7rIfR5t1GcKdKzbUqlcrIVuUT2o60hfenOkAWz2v1VeD54PPkP9wC4pAOat"
    "sKerT2xWfFd70KtdPUDo34A+28TR11saU+G9H70aMEv9pu98sHUKoI/q+NED4Xq45XxQ8d8U"
    "qtyVlqjVntaBQOmsejvjjhp4ysv0a4NNpvTFnuqHBX5wZL2sTl2Xqfz8KMyUcGE83S10ohNv"
    "9oYEPwMsWj4VLoxxhe4YB+dbb1d6bvSFXO61MnVVjiKmecGbuA9qqw1+1PnBWJhmE6ysb4Df"
    "W/d8R9PvXZYreaxWvZahPwkjoV2mE9y+baAXXiygvaoDdDLmyb1nAQ29uk5d1HYBvBnTjwZN"
    "nw9J0edNRRPzlR9KDTCsU7KyZ8NHueLL7rTXhMmQleoCSed+VwZld4GgLQth3dIq9PePk+n+"
    "zl0g6cAu9dc5S+nNFsuU4ZeeqT1WTqW3RzSDEP+l8HT5Ijp6WL7x1p2pEORtAJj4Aw3UBAAd"
    "5Ek73aittpommM77q+qu5J9lGDmJWl8NgJub/eDyDaD+OQbY91Qn86uwLimcRN3vHlEXLhlB"
    "H2cugsi+p5UL18fQMV2QRxe8oPT6DNWxd1flXKPm4D66kmns4yGm+k6zqS/GE925OVBlSjNI"
    "+tYfHhYG0NBfotSerYeATUgARCT4Q8n4ThBfuxGtsscGbo/yhslBQD2PLYT356aDdvck9Yne"
    "BQKzP6mb+8ym4oTvaSOfSZCa4wlxo5LVNLUzNFcNtLCbga6xqQRLbvSCm74+wDkelLvXrAzP"
    "l4r0edehcDlmCdxyeaAEe2cq8FsrCK3dGPpe1SmhrrZy01CglZzvqnNn8fC2HeaCpgtpyVQ7"
    "2kjrSXutNcCyZTXgwW+EfjttEjUsO6qv1NwDxr8wgJs0F+Yow8Bx+XJTZLPKdFv8QjBktVVH"
    "H8hRDbuGw7djbNQlW+fJS+yGKHOOD4KJU+ZSn94x6ogJz5Uu16fQ+fsMcLfBQ+XGYaAZM/eZ"
    "Lp2Xobd3d6ivvlTCLir0Z8NcCKvSEB4cC1GC1kkQP8yL1mrwWumUfcC0f1O4/mHMWFPOY3eo"
    "OtoTrOv3p8ZJgerkFfVg/sLf5OFTBfglsBoUOCjQoLijfOy8P9Ro2Vu1fTeAeu6eSFdPb0Br"
    "h3aC/tdT5F4tRlCnEfPouqZ+dNBAiXpEDoXZtXP0kcMMNPb1YrqGD1L8cg0UvK6pm6TJULBv"
    "Mb3Q6KXcTtML5p1eAN5eV9RDja2gnsYXKjdoqTjRHvTlwpWKq9EAE153CPZouBSe3OlPfznj"
    "B1KtADoxNICO22Kg8+/u0Tfq0p5m+pxR+k1pR+GeF1RBncQFY+3YoS5df6Gxmr6koXpq7wLa"
    "aGGEOvvyXHppv4HqJ/lCfEkzdcF0f1rBbQJtfrAjPdMxUhm7bg69GeEFre8Z6H1/bzpvujMd"
    "9WAiXRmWqbgnG0C6OYKezulCD/nZ6PUe3jD7m1iTb9Jo2MfbwtyeD5Xq3w+GK1tMap/YcdR3"
    "7jU1d85Fpb/rHLqx2yjauWkjqrzQqyszsmSNaoCfJ/mAe8wwaNm+C3yTckUd3L4CFG7wVWfE"
    "pyrTB+9V99RaBLGvAujGqrdVbbulMMLxhdJm2ll9u0l3ZKur7WTdUA86u4UnXMdYv3yIgX5+"
    "mKOufrGQpjb7SYmoXhmqn21MVx2sDGts/cG9yAC9/Iaq1W5qoZlWoklDq9E010FK/RnjqPWo"
    "xbTBcl+4sOOzbMONUb57EqKO99uiDJIWKr0G8bAztwmtlHXCNGOhhr4qXETbRfvRqBoTlXWB"
    "P8A0O16d4Npd6dN3hX7isGR1Rtg82uHMFlPfDz608YlZNKpZmKlgxwh65N364Esbu0B2pIEq"
    "W1+ptfoawH5LJ5qhXFZvhPWFi+4CNBy2COLOrVUzc/2hUUYF+mp7DzB+7k6/SR5MTXo9HWsc"
    "DGPcDKA8WauumNwaUq+Hq8tnecCsNH+waTcTvts2kG5zPK6GbH2v7J43Xq06ogWsmDWfHqYi"
    "ROe3o43DwuXsqxdMNTbOAL/kxvS6qUC9Vs0ZqiVPom+8O9Kiyo3gqtoY6v3aHM7WGExb7cxS"
    "nyU1U8N7GmivNXPotLPTafiTWvDrxjUm97B56qH1AVB0tItyy3UxtLy1TXUNnAtZBxbRrO/m"
    "oy3600OeharnrBNK7UsGqBYyCcY15CCowRg6alG6oukL6v3kWtSHdIHxez6qwSUGWBOwFPya"
    "aKjXwpp0S+MpVDe6pmlEwrd0mbRXnaY5YDrqFabcgsv6oOVjaOeB/vCoWnMIammv+lZuT11y"
    "ulP3G97Q7901+VrcEBpw7w/5VNtjaslYAl29XeGohz+ViwPVAeN3yz0yDHD5orNaOn8W/SNk"
    "MV01KUodGGZPs7wjld93dwDT1MpypZd14cJWGzh1wIOOnDOXuh/YEVwtZCkNOoHfzV7+AG/f"
    "T4aVdefQRy9DlIVJCyB3vBc4XFgEHzeMgQuVDEDPt4Vkn7m00bxd6psAT2jabQn9337/z8sv"
    "KCwqLiklnJX5v66/OtFoHQu/PnUuKPr6/B+nFf9xWjWslCevEK/NPcA8eYt4h7hWKpBAhBER"
    "hAhGmBAqgiKuI24gbiJuIW4j7iDuIu4h/kTcRzxAPEQ8QjxGPEE8RTxDPP9bb3FMKUdC8b2s"
    "Nzkej1+a+745cz92EiLZ3Ktt6VvOL+vJLmA92IhCkRDW7lfEE1LMIQgh/ggZURPhSFgrHGvQ"
    "smzWZT3WNRB6xFJEEQN7FucoEC390qzfm/VMsx7pVHx3XFmv+N/7oF+V9Uj/V/90xP+lFzrm"
    "P/qnk8p63P/e355e1nOdWdY7nV3WA1/e58563AvK+t3Le+FLyvrhXVz+pcv6q62Ci3MFF0vH"
    "tbnZ2ty3wVqsrSxcsdPYO7BeA+cKzq7/D1u5cC9KRTSyiIoTUXEiKk5ExYmoONGstDfmvYjK"
    "E1F5olmJ4ebjckWK5gb+CNx/RHxCfDArVESFsmuiWdHR5uvsnbxZ4R9xH1/W8M9+QJCE+2QE"
    "a/rPKmv6Z4Rjzf6s6b/gb6QqKGugZ439hbyFHAWIwjLC6MsI5PAv5HIsIx4jYEEZuQrZ87zl"
    "BwIFbE7B8gOCwjKyFZY16DNyM9IzoiXgOhMRn3DtrEk/AfH5bz+KSDQfi2ZixeI+DhGPSEAk"
    "IpLM+mFkElFmEfUgoryimYDp5us8vkdEPYhfCJmFx9mIHEQuIg+RjyhAFCKKEMWIEkQpwtW1"
    "omVztXzguUvZGZ64uLq4ILMqVLA08zuaO4Q0X5HLzk7zpefFydm5QgULXV0qun41L0765VXm"
    "LQoVFI2IQcSavZNFDqY0gsJ/HTVSywxdrtjyX3tEIorKokcJGigADVWLsKZEy8bakllLAftv"
    "/BJEMd5XjPenIVk+s19PlFp+RZGLyEPkIwrMYxyOcTjG4RiHYxwqj0Plcag8DpXHofI44vx/"
    "bA5ajWDDc1bWtnZaB7FssMKXLbKMAVFlP4kpZ0JcGdMTyljBLJuMSDGzn4VV3rxI9rOXImRY"
    "iVAmNLEI7VQmLCkTvla50JxF6BIUuqDsJyPpZtbwqEQelch+lsPjOJufR4F5FJj91IZHgXkU"
    "mEeBeRSY/0c4+rI5V3DSau0EayuOt7HVMKG/vu7qWi7I/yaeZpktYrEQs1QhWNw9r8zlv7Cg"
    "TPB/U0jA3xTC3JW5KlNmuWKy8R0Wxf//jN3/DNXIB/aLGAetna1ZZyyRm0Pzv0V45u3M08u9"
    "/O/enVn2k6rypeaYl2exba45UghmkdLMdraoj4mZZ7CojzmC2SH+lnb/S3Xl6ZWlaHOqZuqW"
    "LCbIN1hUWO5A5c5Tzqt0M6/Er9SYb45OFnX+V2QqixNmtbBwYs5wopM5uVlUZ2ladBLFsrCD"
    "Ecb1S5TJkDKlLClbypFypTwpTyxB+zuZBbJCkRRkQr5UIBVKRVKxVCKVQClYWvgcHZDM6MFI"
    "Zsu5kxObwHJzHuRDkWCZysqsH8tUBWKOVACF5j7zL1M5Of3lFw6Olv6mJ9JT6Zn0XHohhUih"
    "0kspTHolvZbeSG+ld9J7KVz6IEVIH6VPUqT0WYqSoqUYKVbKEIrxJX+tvYjk8Y+kOCleSpAS"
    "pSTpsZQspUiprDle+lrq/5DwXzbGRia0nf1/3uLklJSckpqWnpGZlV3Diti65eSWV7d/9b3Z"
    "WLFWyy/b/wDMYK+n"
))

FF_AAC_SCALEFACTOR_CODE = np.frombuffer(_RAW[0:484], "<u4").reshape((121,))
FF_AAC_SCALEFACTOR_BITS = np.frombuffer(_RAW[484:605], "<u1").reshape((121,))
FF_AAC_SPECTRAL_SIZES = np.frombuffer(_RAW[605:627], "<u2").reshape((11,))
CODES1 = np.frombuffer(_RAW[627:789], "<u2").reshape((81,))
CODES2 = np.frombuffer(_RAW[789:951], "<u2").reshape((81,))
CODES3 = np.frombuffer(_RAW[951:1113], "<u2").reshape((81,))
CODES4 = np.frombuffer(_RAW[1113:1275], "<u2").reshape((81,))
CODES5 = np.frombuffer(_RAW[1275:1437], "<u2").reshape((81,))
CODES6 = np.frombuffer(_RAW[1437:1599], "<u2").reshape((81,))
CODES7 = np.frombuffer(_RAW[1599:1727], "<u2").reshape((64,))
CODES8 = np.frombuffer(_RAW[1727:1855], "<u2").reshape((64,))
CODES9 = np.frombuffer(_RAW[1855:2193], "<u2").reshape((169,))
CODES10 = np.frombuffer(_RAW[2193:2531], "<u2").reshape((169,))
CODES11 = np.frombuffer(_RAW[2531:3109], "<u2").reshape((289,))
BITS1 = np.frombuffer(_RAW[3109:3190], "<u1").reshape((81,))
BITS2 = np.frombuffer(_RAW[3190:3271], "<u1").reshape((81,))
BITS3 = np.frombuffer(_RAW[3271:3352], "<u1").reshape((81,))
BITS4 = np.frombuffer(_RAW[3352:3433], "<u1").reshape((81,))
BITS5 = np.frombuffer(_RAW[3433:3514], "<u1").reshape((81,))
BITS6 = np.frombuffer(_RAW[3514:3595], "<u1").reshape((81,))
BITS7 = np.frombuffer(_RAW[3595:3659], "<u1").reshape((64,))
BITS8 = np.frombuffer(_RAW[3659:3723], "<u1").reshape((64,))
BITS9 = np.frombuffer(_RAW[3723:3892], "<u1").reshape((169,))
BITS10 = np.frombuffer(_RAW[3892:4061], "<u1").reshape((169,))
BITS11 = np.frombuffer(_RAW[4061:4350], "<u1").reshape((289,))
SWB_OFFSET_1024_24 = np.frombuffer(_RAW[4350:4446], "<u2").reshape((48,))
SWB_OFFSET_128_24 = np.frombuffer(_RAW[4446:4478], "<u2").reshape((16,))
SWB_OFFSET_1024_48 = np.frombuffer(_RAW[4478:4578], "<u2").reshape((50,))
SWB_OFFSET_128_48 = np.frombuffer(_RAW[4578:4608], "<u2").reshape((15,))
FF_AAC_NUM_SWB_1024 = np.frombuffer(_RAW[4608:4621], "<u1").reshape((13,))
FF_AAC_NUM_SWB_128 = np.frombuffer(_RAW[4621:4634], "<u1").reshape((13,))
FF_TNS_MAX_BANDS_1024 = np.frombuffer(_RAW[4634:4647], "<u1").reshape((13,))
FF_TNS_MAX_BANDS_128 = np.frombuffer(_RAW[4647:4660], "<u1").reshape((13,))
TNS_TMP2_MAP_0_3 = np.frombuffer(_RAW[4660:4692], "<f4").reshape((8,))
TNS_TMP2_MAP_0_4 = np.frombuffer(_RAW[4692:4756], "<f4").reshape((16,))
TNS_TMP2_MAP_1_3 = np.frombuffer(_RAW[4756:4772], "<f4").reshape((4,))
TNS_TMP2_MAP_1_4 = np.frombuffer(_RAW[4772:4804], "<f4").reshape((8,))
SBR_QMF_WINDOW_US = np.frombuffer(_RAW[4804:7364], "<f4").reshape((640,))
FF_SBR_NOISE_TABLE = np.frombuffer(_RAW[7364:11524], "<f4").reshape((520, 2))
SBR_OFFSET = np.frombuffer(_RAW[11524:11620], "<i1").reshape((6, 16))
T_HUFFMAN_ENV_1_5DB_CODES = np.frombuffer(_RAW[11620:12104], "<u4").reshape((121,))
T_HUFFMAN_ENV_1_5DB_BITS = np.frombuffer(_RAW[12104:12225], "<u1").reshape((121,))
F_HUFFMAN_ENV_1_5DB_CODES = np.frombuffer(_RAW[12225:12709], "<u4").reshape((121,))
F_HUFFMAN_ENV_1_5DB_BITS = np.frombuffer(_RAW[12709:12830], "<u1").reshape((121,))
T_HUFFMAN_ENV_BAL_1_5DB_CODES = np.frombuffer(_RAW[12830:13026], "<u4").reshape((49,))
T_HUFFMAN_ENV_BAL_1_5DB_BITS = np.frombuffer(_RAW[13026:13075], "<u1").reshape((49,))
F_HUFFMAN_ENV_BAL_1_5DB_CODES = np.frombuffer(_RAW[13075:13271], "<u4").reshape((49,))
F_HUFFMAN_ENV_BAL_1_5DB_BITS = np.frombuffer(_RAW[13271:13320], "<u1").reshape((49,))
T_HUFFMAN_ENV_3_0DB_CODES = np.frombuffer(_RAW[13320:13572], "<u4").reshape((63,))
T_HUFFMAN_ENV_3_0DB_BITS = np.frombuffer(_RAW[13572:13635], "<u1").reshape((63,))
F_HUFFMAN_ENV_3_0DB_CODES = np.frombuffer(_RAW[13635:13887], "<u4").reshape((63,))
F_HUFFMAN_ENV_3_0DB_BITS = np.frombuffer(_RAW[13887:13950], "<u1").reshape((63,))
T_HUFFMAN_ENV_BAL_3_0DB_CODES = np.frombuffer(_RAW[13950:14000], "<u2").reshape((25,))
T_HUFFMAN_ENV_BAL_3_0DB_BITS = np.frombuffer(_RAW[14000:14025], "<u1").reshape((25,))
F_HUFFMAN_ENV_BAL_3_0DB_CODES = np.frombuffer(_RAW[14025:14075], "<u2").reshape((25,))
F_HUFFMAN_ENV_BAL_3_0DB_BITS = np.frombuffer(_RAW[14075:14100], "<u1").reshape((25,))
T_HUFFMAN_NOISE_3_0DB_CODES = np.frombuffer(_RAW[14100:14226], "<u2").reshape((63,))
T_HUFFMAN_NOISE_3_0DB_BITS = np.frombuffer(_RAW[14226:14289], "<u1").reshape((63,))
T_HUFFMAN_NOISE_BAL_3_0DB_CODES = np.frombuffer(_RAW[14289:14314], "<u1").reshape((25,))
T_HUFFMAN_NOISE_BAL_3_0DB_BITS = np.frombuffer(_RAW[14314:14339], "<u1").reshape((25,))
