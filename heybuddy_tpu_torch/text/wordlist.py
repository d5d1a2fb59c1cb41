"""
Built-in English word list for the offline adversarial-phrase lexicon.

A copy of the JAX package's ``text/wordlist.py``: the same words in the same
order, so seeded adversarial pools are equal in both packages.

The reference searches the CMU pronouncing dictionary (~134k words) via the
``pronouncing`` package (reference util/lang_util.py:84-167). When no CMU
dictionary file is available, this bundled list of common English words,
phonemized by the rule G2P, provides an offline search corpus. Point
``HEYBUDDY_CMUDICT`` at a real cmudict file to upgrade to full coverage.
"""

WORDS = """
able about above across act action active actor add address admit adult affect after again against age
agent ago agree ahead air all allow almost alone along already also although always among amount and
angel anger angle animal announce annual another answer any anyone anything appear apple apply approach
april area argue arm army around arrive art article artist ask assume attack attempt attend attention
august aunt author auto autumn avoid away baby back bad bag ball balloon banana band bank bar base
baseball basic basket battle beach bean bear beat beauty become bed before begin behind believe bell
belong below bench bend benefit best better between beyond big bill bird birth bit black blade blame
blanket block blood blue board boat body bone book boot border born borrow boss both bottle bottom
bowl box boy brain branch brave bread break breakfast breath brick bridge brief bright bring broad
brother brown brush bubble budget build bundle burn bus bush business butter button cabin cable cake
camera camp candle candy cap capital captain car card care carry case cash cast cat catch cattle
cause celebrate cell center central century certain chain chair chance change channel chapter charge
chart chase cheap check cheese cherry chest chicken chief child choice choose church circle city claim
class clean clear climb clock close cloth cloud club coach coast coat code coffee cold collect college
color column combine comfort common company concern condition conduct connect consider contain continue
control cook cool copper copy corn corner correct cost cotton count country couple courage course court
cover cow crack craft crash cream create credit crew crime cross crowd crown cruel crush cry culture
cup curious current curtain curve custom cut cycle dad daily damage dance danger dark data date
daughter day dead deal dear debate decade december decide deep deer defend degree deliver demand
density deny depend describe desert design desk detail develop device dial diamond differ difficult
dig dinner direct dirt discuss dish distance divide doctor dog dollar door double doubt dozen drag
draw dream dress drink drive drop dry duck due dull during dust duty each eager ear early earn earth
east easy eat edge effect effort egg eight either elbow elder electric element eleven else empty end
enemy energy engine enjoy enter entire equal escape even evening event ever every exact example except
excite exercise exist expect expert explain express extra face fact factory fail fair fall family
famous fan far farm fast fat father fault favor fear feature february feed feel fellow fence festival
fever few field fifteen fifty fight figure fill film final find fine finger finish fire firm first
fish fit five fix flag flame flat flavor floor flow flower fly fold folk follow food foot force
forest forget form fort forty four frame free fresh friday frog front fruit fuel full fun funny
gain game garden gas gate gather gave general gentle get gift girl glad glass globe goal gold golf
good grab grade grain grand grant grass gray great green ground group guard guess guest guide gun
habit hair half hall hand handle hang happen happy hard harm hat hate head health heart heat heavy
held help her hide high hill him his history hit hold hole holiday home honey honor hope horn horse
hospital hot hotel hour huge human hundred hunt hurry hurt husband ice idea image imagine important
inch include income indeed indoor industry inform inside instead iron island issue item jacket january
job join joke journey joy judge juice july jump june jungle just keep key kick kid kill kind king
kiss kitchen knee knife knock lack lady lake land language large last late later lead leader leaf
learn least leather leave left leg lemon length less lesson let letter level library lie life lift
like limit line link lion lip list local lock log long look loose lose loss lost lot loud low
luck lunch mad made mail main major make man manage map march mark market marry mass master match
material matter mean meat medal media meet member memory mention menu mercy merry message metal
method middle mile milk mill million mind mine minor minute mirror miss mission mister mix model
modern moment monday money monitor monkey month moon more morning most mother motor mount mountain
mouth much mud muscle museum must nail name narrow near neck need needle neighbor neither nerve nest
net never next nice nickel nine noble node noise noon north nose note nothing notice november number
nurse nut object observe ocean october odd offer office officer often oil old olive one onion only
onto operate opinion orange order organ other ounce outcome outdoor output outside oven owner pace
pack page pain paint pair palace pan panel paper parent park part party pass past path pattern pay
peace pear pen pencil penny per perfect perform period person phone photo piano pick piece pig pile
pilot pin pink pipe pitch place plan plane planet plant plastic plate platform pleasant plenty pocket
point pole police policy pond pool poor pop popular port position positive possible post pot potato
pound powder power practice present press pretty prevent price pride prince princess prize problem
process produce product profit program project promise proof proper protect proud prove provide public
pull pump punch pupil puppy pure purple purpose push put puzzle quality quarter queen quest quick
quiet quit quite rabbit race radio rail rain raise range rapid rare rate rather raw reach react
ready real reason recall receive recent recipe record red reduce refer reflect region regular relate
remain remember remind remote renew rent repair replace reply report request require rescue research
reserve resource respect respond rest result return reveal rice rich ride ridge rifle ring rise risk
river road rob rock rocket roll roof room root rope rose rough round route row royal rub ruin rule
run rural rush sad saddle safe sail salad salt same sample sand save scale scene school science
score screen sea season seat second secret section secure see seed seek seem select self sell send
senior sense sentence series serious serve service session seven several shade shadow shake shall
shape share sharp sheep sheet shelf shell shine ship shirt shock shoe shoot shop shore short shot
shoulder shout shut side sight sign signal silent silver similar simple since sing single sink sir
sister sit six size skill skin skirt sky sleep slice slide slip small smart smell smile smoke smooth
snake snow soap soccer society sock soft soil soldier solid solve son song soon sort soul source
south space spare speak speed spell spend spirit split spoon sport spot spread spring square stable
staff stage stair stamp stand star stare state statue stay steady steal steam steel stem step stick
still stock stomach stone store storm story straight strange stream street stress stretch strike
string strong student study stuff style subject such sudden suffer suit summer sun sunday super
supply support surface surprise survey sweet swim switch symbol system table tail take tale talent
talk tall tank tape target task taste tax tea teach team tear tell temple ten tend tennis tent term
test text thank theater theme then theory thick thin thing think third thirty threat three throat
throw thumb thunder thursday ticket tide tie tiger tight till tin tiny tip tire tissue title toast
toe together toilet tone tongue tonight too tool tooth top topic total touch tour toward tower town
toy trace track trade traffic trail train transfer trap travel treat tree trial tribe trick trip
trouble truck true trust truth try tube tuesday tune tunnel turkey twelve twenty twice twin type
ugly uncle under union unit until upon upper upset urban urge use useful usual valley value van
variety various vast vegetable vehicle verse very vessel victory video view village violet visit
voice volume vote wage wagon wait walk wall want war warm warn wash waste watch wave way weak wealth
weapon wear wedding wednesday week weird welcome well west wet wheel while whisper white whole wide
wife wild win wind window wine wing winter wire wise wish within without witness wolf wonder wood
wool worry worth wound wrap wrist write wrong yard yellow yes yesterday yet young zero zone
melon mellow fellow halo hollow willow pillow yell hull hall hulk held helm weld well whirl
word worm worse birthday burden burger curl curb dirty early earl earn firm first girl
hurl journal kernel learner merge nurse pearl person purse search serge stern swirl turn
verb verse whirl worker burly furry hurry jury merit peril barrel
body buddy muddy study ruddy daddy teddy lady shady tidy windy candy dandy handy sandy
bundle handle candle middle riddle paddle saddle puddle noodle poodle
hollow follow fallow mallow shallow swallow yellow
bunny sunny penny granny nanny skinny tiny pony puny bony zany rainy
buggy muggy foggy doggy soggy baggy piggy
puppy putty petty pity party potty patty bully belly jelly silly
hay bay jay lay may nay pay ray clay gray pray stay tray stray spray
gravy navy wavy ivy envy
cuddle huddle muddle
but bud bun buck bug bull buzz bump bulk bus bust booth book boom
bat bet bit bot beat beet bead bid bad bed bead bud bug
hem hen head heap heat heal heel hail hale haze hate
said sad sit sat set sud suds stud study studio steady sturdy buddies
""".split()
